"""Wrapper of the hand-written Hopper skewed-bucket kernel (paper Algorithm 1).

Replaces ``repro/kernels/skewed_bucket.py::skewed_bucket``, the Pallas TPU
kernel (body ``_bucket_kernel``); the source is ``csrc/skewed_bucket.cu``,
built by ``build.py`` and called through its C interface with ``ctypes``.

Bound on an H100: bytes, 8 B per hash (an int32 read, an int32 written):
~0.0116 ms at PageRank's 4,847,571 vertices and 3.35 TB/s. One thread maps
four hashes against the prefix sums, staged in shared memory in tiles of
1024 and counted tile by tile, so any number of capacities is taken.

The Pallas wrapper had two paths for the hash-space size (folded into the
kernel when the capacities were static, taken outside when traced). Here
there is one: ``skewed_bucket`` computes the inclusive prefix sums on the
card and the kernel reads the total from their last element. The wrapper
reads the E capacities back once to refuse a non-positive or overflowing
total (a division by zero on the card would not be reported).

``launches`` counts the launches made by ``launch``, so a run can show that
its main path went through the kernel.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

launches = 0

INT32_MAX = 2**31 - 1


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = build.load("skewed_bucket")
    lib.skewed_bucket_fwd.restype = ctypes.c_int
    lib.skewed_bucket_fwd.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong,
                                                              ctypes.c_int, ctypes.c_void_p]
    lib.skewed_bucket_error_string.restype = ctypes.c_char_p
    lib.skewed_bucket_error_string.argtypes = [ctypes.c_int]
    return lib


def _check_int32_vector(name: str, t: torch.Tensor) -> None:
    if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"skewed_bucket kernel: {name} must be a contiguous 1-D "
                         f"int32 tensor, got {t.dtype} of shape {tuple(t.shape)}")


def launch(hashes: torch.Tensor, cum: torch.Tensor) -> torch.Tensor:
    """Launches the kernel on ``cum``, the int32 inclusive prefix sums of the
    capacities, whose last element must be positive: ``skewed_bucket``
    computes and checks them. Returns (T,) int32 buckets; does not
    synchronise."""
    global launches
    _check_int32_vector("hashes", hashes)
    _check_int32_vector("cum", cum)
    for name, t in (("hashes", hashes), ("cum", cum)):
        if not t.is_cuda:
            raise ValueError(f"skewed_bucket kernel: {name} must be a CUDA tensor, "
                             f"got {t.device}")
    if cum.device != hashes.device:
        raise ValueError("skewed_bucket kernel: hashes and cum on different devices")
    if not 1 <= cum.numel() <= INT32_MAX:
        raise ValueError(f"skewed_bucket kernel: {cum.numel()} buckets not in "
                         f"[1, {INT32_MAX}]")
    out = torch.empty_like(hashes)
    if hashes.numel() == 0:
        return out
    lib = _library()
    with torch.cuda.device(hashes.device):
        stream = torch.cuda.current_stream(hashes.device).cuda_stream
        err = lib.skewed_bucket_fwd(hashes.data_ptr(), cum.data_ptr(), out.data_ptr(),
                                    hashes.numel(), cum.numel(), stream)
    if err != 0:
        raise RuntimeError("skewed_bucket kernel launch failed: "
                           + lib.skewed_bucket_error_string(err).decode())
    launches += 1
    return out


def skewed_bucket(hashes: torch.Tensor, capacities: torch.Tensor) -> torch.Tensor:
    """hashes (T,) int32 and capacities (E,) int32 on one card, E >= 1,
    with a sum in [1, 2**31 - 1]. Returns (T,) int32 bucket ids
    in [0, E). Zero capacities are legal: their buckets receive nothing.

    Raises on input the kernel does not take (the total is checked before
    the device, so a bad total is refused on any tensor) and on a failed
    build or launch.
    """
    _check_int32_vector("hashes", hashes)
    _check_int32_vector("capacities", capacities)
    total = int(capacities.to(torch.int64).sum())     # one read-back of E ints
    if not 1 <= total <= INT32_MAX:
        raise ValueError(f"skewed_bucket kernel: capacities sum to {total}, "
                         f"outside [1, {INT32_MAX}]")
    return launch(hashes, torch.cumsum(capacities, 0, dtype=torch.int32))
