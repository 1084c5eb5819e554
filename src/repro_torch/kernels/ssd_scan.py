"""Wrapper of the hand-written Hopper SSD-scan kernel.

Replaces ``repro/kernels/ssd_scan.py::ssd_scan``, the Pallas TPU kernel
(body ``_ssd_kernel``); the source is ``csrc/ssd_scan.cu``, built by
``build.py`` and called through its C interface with ``ctypes``.

Bound on an H100: at the serving shape (b 10, S 1024, H 80, P 64, N 128,
B/C bf16) the call moves ~454 MB, xdt and y in fp32 most of it, so it is
bound by bytes (~0.14 ms at 3.35 TB/s). This first kernel computes in fp32
on the CUDA cores: one block per (batch x head, P-slice) loops over
64-row chunks with its slice of the state in shared memory.

``launches`` counts the launches made by this wrapper, so a run can show
that its main path went through the kernel.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import build

launches = 0

MAX_STATE = 128
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = build.load("ssd_scan")
    lib.ssd_scan_fwd.restype = ctypes.c_int
    lib.ssd_scan_fwd.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 4
        + [ctypes.c_int, ctypes.c_void_p])
    lib.ssd_scan_plan.restype = ctypes.c_int
    lib.ssd_scan_plan.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
    lib.ssd_scan_error_string.restype = ctypes.c_char_p
    lib.ssd_scan_error_string.argtypes = [ctypes.c_int]
    return lib


def plan(batch: int, heads: int, p: int, n: int) -> Dict[str, int]:
    """The launch the kernel makes at these sizes on the current card:
    chunk rows, P-slice width, padded state width, dynamic shared memory
    bytes of one block."""
    lib = _library()
    out = (ctypes.c_int * 4)()
    err = lib.ssd_scan_plan(batch, heads, p, n, out)
    if err != 0:
        raise ValueError("ssd_scan plan: " + lib.ssd_scan_error_string(err).decode())
    return dict(zip(("chunk", "p_slice", "state_width", "smem_bytes"), out))


def _check(xdt: torch.Tensor, dta: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
           init_state: Optional[torch.Tensor]) -> None:
    named = [("xdt", xdt), ("dta", dta), ("B", B), ("C", C)]
    if init_state is not None:
        named.append(("init_state", init_state))
    for name, t in named:
        if not t.is_cuda:
            raise ValueError(f"ssd_scan kernel: {name} must be a CUDA tensor, "
                             f"got {t.device}")
        if t.device != xdt.device:
            raise ValueError("ssd_scan kernel: inputs on different devices")
    for name, t in (("xdt", xdt), ("dta", dta), ("init_state", init_state)):
        if t is not None and (t.dtype != torch.float32 or not t.is_contiguous()):
            raise ValueError(f"ssd_scan kernel: {name} must be contiguous float32")
    if xdt.dim() != 4 or B.dim() != 4 or C.dim() != 4:
        raise ValueError("ssd_scan kernel: xdt, B and C must be 4-D")
    bsz, s, h, p = xdt.shape
    g, n = B.shape[2], B.shape[3]
    if tuple(dta.shape) != (bsz, s, h):
        raise ValueError(f"ssd_scan kernel: dta {tuple(dta.shape)} != {(bsz, s, h)}")
    if B.shape != C.shape or tuple(B.shape[:2]) != (bsz, s):
        raise ValueError(f"ssd_scan kernel: B {tuple(B.shape)} and C {tuple(C.shape)} "
                         f"do not match xdt {tuple(xdt.shape)}")
    if B.dtype != C.dtype or B.dtype not in _DTYPE_CODES:
        raise ValueError(f"ssd_scan kernel: B and C must both be float32 or "
                         f"bfloat16, got {B.dtype} and {C.dtype}")
    for name, t in (("B", B), ("C", C)):
        # a dim of size 1 may carry any stride
        if (n > 1 and t.stride(3) != 1) or (g > 1 and t.stride(2) != n):
            raise ValueError(f"ssd_scan kernel: {name} needs contiguous "
                             "(groups, state) dims")
    if g == 0 or h % g != 0:
        raise ValueError(f"ssd_scan kernel: {h} heads are not a multiple of "
                         f"{g} groups")
    if not 1 <= n <= MAX_STATE:
        raise ValueError(f"ssd_scan kernel: state dim {n} not in [1, {MAX_STATE}]")
    if init_state is not None and tuple(init_state.shape) != (bsz, h, p, n):
        raise ValueError(f"ssd_scan kernel: init_state {tuple(init_state.shape)} "
                         f"!= {(bsz, h, p, n)}")


def ssd_scan(xdt: torch.Tensor, dta: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
             *, init_state: Optional[torch.Tensor] = None,
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """xdt (b, S, H, P) and dta (b, S, H) float32; B/C (b, S, G, N) float32
    or bfloat16, G | H; init_state (b, H, P, N) float32 or None (zeros).
    Returns (y (b, S, H, P) float32, final state (b, H, P, N) float32).

    S need not be a multiple of any chunk: the kernel masks the ragged
    chunk. Raises on input the kernel does not take and on a failed build
    or launch.
    """
    global launches
    _check(xdt, dta, B, C, init_state)
    bsz, s, h, p = xdt.shape
    g, n = B.shape[2], B.shape[3]
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
        raise RuntimeError("ssd_scan kernel launch failed: "
                           + lib.ssd_scan_error_string(err).decode())
    launches += 1
    return y, fin
