"""Wrapper of the hand-written Hopper SSD-scan kernels.

Replaces ``repro/kernels/ssd_scan.py::ssd_scan``, the Pallas TPU kernel
(body ``_ssd_kernel``), and the elementwise prep of its wrapper
``repro/kernels/ops.py::ssd_scan``; the source is ``csrc/ssd_scan.cu``,
built by ``build.py`` and called through its C interface with ``ctypes``.

The dtype of x alone picks the route (``route_for``):

* ``bfloat16`` -> ``"wgmma"``: every product on the tensor cores
  (``wgmma.mma_async``, fp32 accumulators in registers). The kernel reads
  x, B and C in bf16 where they lie (TMA tensor maps built from their
  strides, so the model's strided views of its conv output need no copy),
  dt and a_log in fp32, and writes y in x's dtype (or fp32 on request) and
  the fp32 final state: the prep passes ``x.float()``, ``x * dt``,
  ``dt * a`` and the cast of y are folded in. Plain bf16 or TF32 operands
  miss the reference's 2e-3 tolerance, so x, B and C stay exact and every
  factor computed in fp32 (the masked, decayed C B^T times dt, x times its
  decay, the state) is split into bf16 hi + lo. A persistent grid, two
  (batch, head) items per block, each with a two-stage TMA ring of 64-row
  chunks; y leaves by TMA stores. Bound on an H100 at the serving shape
  (b 10, S 1024, H 80, P 64, N 128): ~244 MB for the whole call, 0.0730
  ms at 3.35 TB/s (one 8192-token prompt: 0.0529 ms), and ~80 GFLOP of
  issued bf16 products, ~0.08 ms. It takes P <= 64 and N <= 128, each a
  multiple of 8, 16 B aligned base pointers and (batch, seq, head) strides
  of 16 B multiples (``wgmma_layout_error`` names the first violation; the
  wrapper raises on it, never copying).
* ``float32`` -> ``"simt"``: the wrapper computes a = -exp(a_log),
  dta = dt a and xdt = x dt in fp32, and the kernel runs fp32 on the CUDA
  cores (bf16 splits of fp32 x would need x split too): one block per
  (batch x head, P-slice) loops over 64-row chunks with its slice of the
  state in shared memory. Bound by the bytes of xdt and y in fp32 (~454 MB,
  0.1356 ms at the serving shape).

A failed build or launch raises; nothing retries the other route.
``launches`` counts the launches made by this wrapper and
``launches_by_route`` splits them by route, so a run can show that its main
path went through the tensor-core kernel.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import build

launches = 0
launches_by_route = {"wgmma": 0, "simt": 0}

MAX_STATE = 128
ROUTES = {torch.bfloat16: "wgmma", torch.float32: "simt"}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# the wgmma route's tiles, as csrc/ssd_scan.cu lays them out
WGMMA_MAX_HEAD_DIM = 64        # P, padded to 64 in the tiles
WGMMA_MAX_STATE = 128          # N, padded to 128
WGMMA_DIM_MULTIPLE = 8         # P and N: 16 B of bf16
TMA_ALIGN = 16                 # bytes: base pointers and strides


def route_for(dtype: torch.dtype) -> str:
    """The kernel x's dtype runs on: ``"wgmma"`` for bf16, ``"simt"`` for fp32."""
    try:
        return ROUTES[dtype]
    except KeyError:
        raise ValueError(f"ssd_scan kernel: x dtype {dtype} is not float32 or "
                         "bfloat16") from None


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = build.load("ssd_scan")
    lib.ssd_scan_fwd.restype = ctypes.c_int
    lib.ssd_scan_fwd.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 4
        + [ctypes.c_int, ctypes.c_void_p])
    lib.ssd_scan_fwd_wgmma.restype = ctypes.c_int
    lib.ssd_scan_fwd_wgmma.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
        + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_void_p])
    lib.ssd_scan_plan.restype = ctypes.c_int
    lib.ssd_scan_plan.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
    lib.ssd_scan_wgmma_plan.restype = ctypes.c_int
    lib.ssd_scan_wgmma_plan.argtypes = [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)]
    lib.ssd_scan_error_string.restype = ctypes.c_char_p
    lib.ssd_scan_error_string.argtypes = [ctypes.c_int]
    return lib


def plan(route: str, batch: int, heads: int, p: int, n: int) -> Dict[str, int]:
    """The launch ``route`` makes at these sizes on the current card.

    ``"simt"``: chunk rows, P-slice width, padded state width, dynamic
    shared memory bytes of one block. ``"wgmma"``: chunk rows, (batch, head)
    items in flight per block, ring stages, dynamic shared memory bytes of
    one block, blocks in the persistent grid.
    """
    lib = _library()
    if route == "simt":
        out = (ctypes.c_int * 4)()
        err = lib.ssd_scan_plan(batch, heads, p, n, out)
        keys = ("chunk", "p_slice", "state_width", "smem_bytes")
    elif route == "wgmma":
        out = (ctypes.c_int * 5)()
        err = lib.ssd_scan_wgmma_plan(batch, heads, out)
        keys = ("chunk", "heads_per_block", "stages", "smem_bytes", "grid")
    else:
        raise ValueError(f"ssd_scan: unknown route {route!r}")
    if err != 0:
        raise ValueError("ssd_scan plan: " + lib.ssd_scan_error_string(err).decode())
    return dict(zip(keys, out))


def _check_common(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                  init_state: Optional[torch.Tensor]) -> None:
    named = [("x", x), ("dt", dt), ("B", B), ("C", C)]
    if init_state is not None:
        named.append(("init_state", init_state))
    for name, t in named:
        if not t.is_cuda:
            raise ValueError(f"ssd_scan kernel: {name} must be a CUDA tensor, "
                             f"got {t.device}")
        if t.device != x.device:
            raise ValueError("ssd_scan kernel: inputs on different devices")
    if x.dim() != 4 or B.dim() != 4 or C.dim() != 4:
        raise ValueError("ssd_scan kernel: x, B and C must be 4-D")
    bsz, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if tuple(dt.shape) != (bsz, s, h):
        raise ValueError(f"ssd_scan kernel: dt {tuple(dt.shape)} != {(bsz, s, h)}")
    if B.shape != C.shape or tuple(B.shape[:2]) != (bsz, s):
        raise ValueError(f"ssd_scan kernel: B {tuple(B.shape)} and C {tuple(C.shape)} "
                         f"do not match x {tuple(x.shape)}")
    if B.dtype != C.dtype or B.dtype not in _DTYPE_CODES:
        raise ValueError(f"ssd_scan kernel: B and C must both be float32 or "
                         f"bfloat16, got {B.dtype} and {C.dtype}")
    if g == 0 or h % g != 0:
        raise ValueError(f"ssd_scan kernel: {h} heads are not a multiple of "
                         f"{g} groups")
    if not 1 <= n <= MAX_STATE:
        raise ValueError(f"ssd_scan kernel: state dim {n} not in [1, {MAX_STATE}]")
    if init_state is not None:
        if tuple(init_state.shape) != (bsz, h, p, n):
            raise ValueError(f"ssd_scan kernel: init_state {tuple(init_state.shape)} "
                             f"!= {(bsz, h, p, n)}")
        if init_state.dtype != torch.float32 or not init_state.is_contiguous():
            raise ValueError("ssd_scan kernel: init_state must be contiguous float32")


def tma_strides(t: torch.Tensor) -> tuple:
    """(batch, seq, head or group) element strides for a TMA tensor map; a
    dimension of size 1 is never stepped, so its stride is taken as 8 (16 B)."""
    return tuple(st if n > 1 else TMA_ALIGN // t.element_size()
                 for n, st in zip(t.shape[:3], t.stride()[:3]))


def wgmma_layout_error(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                       B: torch.Tensor, C: torch.Tensor) -> Optional[str]:
    """Why the wgmma route cannot take these inputs as they lie in memory,
    or None. Looks only at dtypes, shapes, strides and addresses, so it
    runs on tensors of any device."""
    p, n = x.shape[-1], B.shape[-1]
    for name, t in (("x", x), ("B", B), ("C", C)):
        if t.dtype != torch.bfloat16:
            return f"{name} is {t.dtype}, not bfloat16"
    for name, t in (("dt", dt), ("a_log", a_log)):
        if t.dtype != torch.float32:
            return f"{name} is {t.dtype}, not float32"
    if a_log.dim() != 1 or a_log.shape[0] != x.shape[2] or not a_log.is_contiguous():
        return f"a_log must be contiguous ({x.shape[2]},), got {tuple(a_log.shape)}"
    for name, size, top in (("head dim P", p, WGMMA_MAX_HEAD_DIM),
                            ("state dim N", n, WGMMA_MAX_STATE)):
        if not (WGMMA_DIM_MULTIPLE <= size <= top and size % WGMMA_DIM_MULTIPLE == 0):
            return (f"{name} {size} is not a multiple of {WGMMA_DIM_MULTIPLE} "
                    f"in [{WGMMA_DIM_MULTIPLE}, {top}]")
    for name, t in (("x", x), ("B", B), ("C", C)):
        if t.stride(3) != 1:
            return f"{name}'s last dim is not contiguous (stride {t.stride(3)})"
        if t.data_ptr() % TMA_ALIGN:
            return (f"{name}.data_ptr() is not {TMA_ALIGN} B aligned "
                    f"(offset {t.data_ptr() % TMA_ALIGN})")
        for dim, st in zip(("batch", "seq", "head/group"), tma_strides(t)):
            if (st * t.element_size()) % TMA_ALIGN:
                return (f"{name}'s {dim} stride is {st * t.element_size()} B, not a "
                        f"multiple of {TMA_ALIGN} B")
    return None


def simt(xdt: torch.Tensor, dta: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
         *, init_state: Optional[torch.Tensor] = None,
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fp32 route's kernel on prepared inputs: xdt (b, S, H, P) and dta
    (b, S, H) contiguous float32; B/C (b, S, G, N) float32 or bfloat16 with
    contiguous (G, N) dims. Returns (y fp32, final state fp32)."""
    global launches
    _check_common(xdt, dta, B, C, init_state)
    for name, t in (("xdt", xdt), ("dta", dta)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"ssd_scan kernel: {name} must be contiguous float32")
    bsz, s, h, p = xdt.shape
    g, n = B.shape[2], B.shape[3]
    for name, t in (("B", B), ("C", C)):
        # a dim of size 1 may carry any stride
        if (n > 1 and t.stride(3) != 1) or (g > 1 and t.stride(2) != n):
            raise ValueError(f"ssd_scan kernel: {name} needs contiguous "
                             "(groups, state) dims")
    y = torch.empty_like(xdt)
    fin = torch.empty((bsz, h, p, n), dtype=torch.float32, device=xdt.device)
    if bsz == 0 or h == 0 or p == 0:
        return y, fin
    lib = _library()
    init_ptr = None if init_state is None else init_state.data_ptr()
    with torch.cuda.device(xdt.device):
        stream = torch.cuda.current_stream(xdt.device).cuda_stream
        err = lib.ssd_scan_fwd(
            xdt.data_ptr(), dta.data_ptr(), B.data_ptr(), C.data_ptr(), init_ptr,
            y.data_ptr(), fin.data_ptr(), bsz, s, h, g, p, n,
            B.stride(0), B.stride(1), C.stride(0), C.stride(1),
            _DTYPE_CODES[B.dtype], stream)
    if err != 0:
        raise RuntimeError("ssd_scan kernel (simt route) launch failed: "
                           + lib.ssd_scan_error_string(err).decode())
    launches += 1
    launches_by_route["simt"] += 1
    return y, fin


def wgmma(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor, B: torch.Tensor,
          C: torch.Tensor, *, init_state: Optional[torch.Tensor] = None,
          y_dtype: Optional[torch.dtype] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The bf16 route's kernel on the model's tensors: x (b, S, H, P) and
    B/C (b, S, G, N) bfloat16, dt (b, S, H) and a_log (H,) float32, any
    strides ``wgmma_layout_error`` accepts. Returns (y in ``y_dtype``,
    bfloat16 or float32, default x's; final state fp32)."""
    global launches
    _check_common(x, dt, B, C, init_state)
    if not a_log.is_cuda or a_log.device != x.device:
        raise ValueError("ssd_scan kernel: a_log must be a CUDA tensor on x's device")
    err = wgmma_layout_error(x, dt, a_log, B, C)
    if err is not None:
        raise ValueError(f"ssd_scan kernel (wgmma route): {err}")
    y_dtype = x.dtype if y_dtype is None else y_dtype
    if y_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"ssd_scan kernel (wgmma route): y dtype {y_dtype} is not "
                         "bfloat16 or float32")
    bsz, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    y = torch.empty((bsz, s, h, p), dtype=y_dtype, device=x.device)
    if bsz == 0 or s == 0:
        fin = (torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
               if init_state is None else init_state.clone())
        return y, fin
    fin = torch.empty((bsz, h, p, n), dtype=torch.float32, device=x.device)
    strides = (ctypes.c_longlong * 12)(*tma_strides(x), *tma_strides(B), *tma_strides(C),
                                       *dt.stride())
    lib = _library()
    init_ptr = None if init_state is None else init_state.data_ptr()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ssd_scan_fwd_wgmma(
            x.data_ptr(), dt.data_ptr(), a_log.data_ptr(), B.data_ptr(), C.data_ptr(),
            init_ptr, y.data_ptr(), fin.data_ptr(), bsz, s, h, g, p, n, strides,
            int(y_dtype == torch.float32), stream)
    if err != 0:
        raise RuntimeError("ssd_scan kernel (wgmma route) launch failed: "
                           + lib.ssd_scan_error_string(err).decode())
    launches += 1
    launches_by_route["wgmma"] += 1
    return y, fin


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor, B: torch.Tensor,
             C: torch.Tensor, *, init_state: Optional[torch.Tensor] = None,
             y_dtype: Optional[torch.dtype] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The contract of ``ref.ssd_scan_ref`` on CUDA tensors: x (b, S, H, P);
    dt (b, S, H) (already softplus'd); a_log (H,); B/C (b, S, G, N), G | H;
    init_state (b, H, P, N) float32 or None (zeros). Returns (y in
    ``y_dtype``, default x's dtype; final state (b, H, P, N) float32).

    x's dtype picks the route. S need not be a multiple of any chunk: the
    kernels mask the ragged chunk. Raises on input the route does not take
    and on a failed build or launch.
    """
    if route_for(x.dtype) == "wgmma":
        return wgmma(x, dt, a_log, B, C, init_state=init_state, y_dtype=y_dtype)
    a = -torch.exp(a_log.float())
    dta = (dt.float() * a).contiguous()
    xdt = (x.float() * dt.float()[..., None]).contiguous()
    y, fin = simt(xdt, dta, B, C, init_state=init_state)
    return (y if y_dtype in (None, torch.float32) else y.to(y_dtype)), fin
