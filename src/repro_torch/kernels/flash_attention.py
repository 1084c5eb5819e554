"""Wrapper of the hand-written Hopper flash-attention forward kernel.

Replaces ``repro/kernels/flash_attention.py::flash_attention``, the Pallas
TPU kernel (body ``_attn_kernel``); the source is
``csrc/flash_attention.cu``, built by ``build.py`` and called through its C
interface with ``ctypes``.

Bound on an H100: causal attention at the serving shape (q (10, 32, 1024,
128), k/v (10, 8, 1024, 128), bf16) does ~86 GFLOP of products over ~210 MB
of inputs and output, about 400 FLOP per byte, so it is bound by
operations: ~87 us at the bf16 tensor-core peak, against ~63 us to move the
bytes. This first kernel computes in fp32 on the CUDA cores (67 TFLOP/s
peak, so >= 1.3 ms), staging each tile once in shared memory and keeping
the online-softmax state in registers; tensor cores (``wgmma``) are the
next step.

``launches`` counts the launches made by this wrapper, so a run can show
that its main path went through the kernel.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import build

launches = 0

MAX_HEAD_DIM = 128
MAX_Q_TILES = 65535            # grid.y limit; 64 query rows per tile
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    lib.flash_attention_fwd.restype = ctypes.c_int
    lib.flash_attention_fwd.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
        + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_int,
           ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_smem_bytes.restype = ctypes.c_int
    lib.flash_attention_smem_bytes.argtypes = [ctypes.c_int]
    return lib


def smem_bytes(head_dim: int) -> int:
    """Dynamic shared memory one block of the kernel takes at ``head_dim``."""
    return _library().flash_attention_smem_bytes(head_dim)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"flash_attention kernel: {name} must be a CUDA "
                             f"tensor, got {t.device}")
        if t.dim() != 4:
            raise ValueError(f"flash_attention kernel: {name} must be 4-D "
                             f"(B, H, S, D), got {tuple(t.shape)}")
        if t.dtype not in _DTYPE_CODES:
            raise ValueError(f"flash_attention kernel: {name} dtype {t.dtype} "
                             "is not float32 or bfloat16")
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention kernel: {name} needs a "
                             "contiguous head_dim (stride(-1) == 1)")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention kernel: q, k, v on different devices")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError("flash_attention kernel: q, k, v dtypes differ")
    b, hq, sq, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"flash_attention kernel: shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)} do not match")
    if k.shape[1] == 0 or hq % k.shape[1] != 0:
        raise ValueError(f"flash_attention kernel: {hq} query heads are not a "
                         f"multiple of {k.shape[1]} kv heads")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention kernel: head_dim {d} not in "
                         f"[1, {MAX_HEAD_DIM}]")
    if -(-sq // 64) > MAX_Q_TILES:
        raise ValueError(f"flash_attention kernel: Sq {sq} is too long")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k/v: (B, Hkv, Sk, D) CUDA tensors -> (B, Hq, Sq, D).

    Any strides with a contiguous last dim; the output is allocated with
    q's layout. Raises on input the kernel does not take and on a failed
    build or launch.
    """
    global launches
    _check(q, k, v)
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    if b == 0 or sq == 0:
        return out
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, hq, hkv, sq, sk, d, strides, float(scale), int(causal),
            int(window), _DTYPE_CODES[q.dtype], stream)
    if err != 0:
        raise RuntimeError("flash_attention kernel launch failed: "
                           + lib.flash_attention_error_string(err).decode())
    launches += 1
    return out
