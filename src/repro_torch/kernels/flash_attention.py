"""Wrapper of the hand-written Hopper flash-attention forward kernels.

Replaces ``repro/kernels/flash_attention.py::flash_attention``, the Pallas
TPU kernel (body ``_attn_kernel``); the source is
``csrc/flash_attention.cu``, built by ``build.py`` and called through its C
interface with ``ctypes``.

Bound on an H100: causal attention at the serving shape (q (10, 32, 1024,
128), k/v (10, 8, 1024, 128), bf16) does ~86 GFLOP of products over ~210 MB
of inputs and output, about 400 FLOP per byte, so it is bound by
operations: 0.0869 ms at the bf16 tensor-core peak, against ~0.063 ms to
move the bytes.

The dtype alone picks the route (``route_for``); both take head dims up
to 256 (gemma3-12b's):

* ``bfloat16`` -> ``"wgmma"``: both products on the tensor cores
  (``wgmma.mma_async``, fp32 accumulators in registers, P fed from registers
  and its softmax run while the previous tile's PV product computes); a
  persistent grid of one block per SM over (batch x head, 128-query tile)
  items, heaviest first; a producer warpgroup loads Q and 128-key K/V tiles
  (64-key at head_dim 256, ``wgmma_block_k``) by TMA into a two-stage ring.
  TMA needs 16 B aligned base pointers and
  (batch, head, seq) strides; ``tma_layout_error`` names the first violation
  and the wrapper raises on it, never copying.
* ``float32`` -> ``"simt"``: fp32 on the CUDA cores (tensor cores would take
  fp32 as TF32, which misses the reference's float32 tolerance).

A failed build or launch raises; nothing retries the other route.
``launches`` counts the launches made by this wrapper and
``launches_by_route`` splits them by route, so a run can show that its main
path went through the tensor-core kernel.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import build

launches = 0
launches_by_route = {"wgmma": 0, "simt": 0}

MAX_HEAD_DIM = 256
MAX_Q_TILES = 65535            # grid.y limit; 64 query rows per simt tile
ROUTES = {torch.bfloat16: "wgmma", torch.float32: "simt"}
_ROUTE_CODES = {"simt": 0, "wgmma": 1}

# the wgmma route's tiles, as csrc/flash_attention.cu lays them out
WGMMA_BLOCK_Q = 128            # query rows per block (two warpgroups of 64)
WGMMA_BLOCK_K = 128            # keys per kv tile (64 at head_dim > 128)
WGMMA_STAGES = 2               # K/V ring depth
WGMMA_COLS = 64                # bf16 per 128 B swizzled shared-memory row
TMA_ALIGN = 16                 # bytes: base pointers and strides


def route_for(dtype: torch.dtype) -> str:
    """The kernel a dtype runs on: ``"wgmma"`` for bf16, ``"simt"`` for fp32."""
    try:
        return ROUTES[dtype]
    except KeyError:
        raise ValueError(f"flash_attention kernel: dtype {dtype} is not float32 "
                         "or bfloat16") from None


def wgmma_block_k(head_dim: int) -> int:
    """Keys per K/V tile of the wgmma route: 128, or 64 above head_dim 128,
    where a two-stage ring of 128-key tiles would not fit shared memory."""
    return WGMMA_BLOCK_K if head_dim <= 2 * WGMMA_COLS else WGMMA_BLOCK_K // 2


def wgmma_smem_bytes(head_dim: int) -> int:
    """Dynamic shared memory of one wgmma block: 1 KB of alignment slack, Q,
    ``WGMMA_STAGES`` x (K + V) in 64-column blocks of 128 B rows, and 128 B
    of mbarriers. Head dims up to 64 take one column block, up to 128 two,
    up to 256 four."""
    blocks = 1 if head_dim <= WGMMA_COLS else (2 if head_dim <= 2 * WGMMA_COLS else 4)
    row = WGMMA_COLS * 2
    return (1024 + blocks * row * WGMMA_BLOCK_Q
            + WGMMA_STAGES * 2 * blocks * row * wgmma_block_k(head_dim) + 128)


def kv_tile_range(q0: int, sk: int, causal: bool, window: int,
                  block_q: int = WGMMA_BLOCK_Q,
                  block_k: int = WGMMA_BLOCK_K) -> range:
    """The kv tiles a query tile starting at ``q0`` visits (the kernels'
    ``kv_tiles``): every tile the causal and window limits leave live."""
    lo = max(0, q0 - window + 1) if window > 0 else 0
    hi = min(sk, q0 + block_q) if causal else sk
    return range(lo // block_k, max(lo // block_k, -(-hi // block_k)))


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p])
    for route in _ROUTE_CODES:
        fn = getattr(lib, f"flash_attention_fwd_{route}")
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_smem_bytes.restype = ctypes.c_int
    lib.flash_attention_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    return lib


def smem_bytes(route: str, head_dim: int) -> int:
    """Dynamic shared memory one block of ``route`` takes at ``head_dim``, as
    the built library reports it."""
    return _library().flash_attention_smem_bytes(_ROUTE_CODES[route], head_dim)


def tma_strides(t: torch.Tensor) -> tuple:
    """(batch, head, seq) element strides for a TMA tensor map; a dimension
    of size 1 is never stepped, so its stride is taken as 8 (16 B)."""
    return tuple(st if n > 1 else TMA_ALIGN // t.element_size()
                 for n, st in zip(t.shape[:3], t.stride()[:3]))


def tma_layout_error(name: str, t: torch.Tensor) -> Optional[str]:
    """Why TMA cannot load ``t`` as it lies in memory, or None."""
    if t.data_ptr() % TMA_ALIGN:
        return (f"{name}.data_ptr() is not {TMA_ALIGN} B aligned "
                f"(offset {t.data_ptr() % TMA_ALIGN})")
    for dim, st in zip(("batch", "head", "seq"), tma_strides(t)):
        if (st * t.element_size()) % TMA_ALIGN:
            return (f"{name}'s {dim} stride is {st * t.element_size()} B, not a "
                    f"multiple of {TMA_ALIGN} B")
    return None


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"flash_attention kernel: {name} must be a CUDA "
                             f"tensor, got {t.device}")
        if t.dim() != 4:
            raise ValueError(f"flash_attention kernel: {name} must be 4-D "
                             f"(B, H, S, D), got {tuple(t.shape)}")
        route_for(t.dtype)
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

    Any strides with a contiguous last dim (bf16 also needs TMA's 16 B
    alignment); the output is allocated with q's layout. Raises on input
    the kernel does not take and on a failed build or launch.
    """
    global launches
    _check(q, k, v)
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    route = route_for(q.dtype)
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    if b == 0 or sq == 0:
        return out
    if sk == 0:                 # no key: every row outputs 0, as l == 0 does
        return out.zero_()
    if route == "wgmma":
        for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
            err = tma_layout_error(name, t)
            if err is not None:
                raise ValueError(f"flash_attention kernel (wgmma route): {err}")
        in_strides = tma_strides(q) + tma_strides(k) + tma_strides(v)
    else:
        in_strides = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
    strides = (ctypes.c_longlong * 12)(*in_strides, *out.stride()[:3])
    lib = _library()
    fn = getattr(lib, f"flash_attention_fwd_{route}")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b, hq, hkv, sq, sk, d, strides, float(scale), int(causal),
                 int(window), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel ({route} route) launch failed: "
                           + lib.flash_attention_error_string(err).decode())
    launches += 1
    launches_by_route[route] += 1
    return out
