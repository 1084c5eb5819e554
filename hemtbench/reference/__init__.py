"""Plain fp32 PyTorch references of the served model families.

One module per family (``dense``, ``ssm``), found by the configuration's
``family``. Each gives the raw weights' names, shapes and draws
(``normal_leaves``, ``other_leaves``) and ``logits(weights, spec, tokens,
first, mm)``: the logits of every position from ``first`` on, computed in
fp32 one layer at a time from the weights as they are handed over (bf16
matrices are cast up as each layer runs). ``mm`` is the matrix product of
the linear layers; ``fp8_mm`` puts every operand through float8 e4m3, which
is the control the check must fail. Nothing here imports the port.
"""
from __future__ import annotations

import contextlib

import torch

FP8_MAX = 448.0          # largest finite float8 e4m3fn


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in fp32, with TF32 off (the card would otherwise round
    fp32 operands to TF32)."""
    return x.float() @ w.float()


def _fp8(t: torch.Tensor, dim) -> torch.Tensor:
    """``t`` rounded through float8 e4m3 with one scale per slice along
    ``dim`` (``None``: one for the whole tensor), back in fp32."""
    t = t.float()
    amax = t.abs().amax() if dim is None else t.abs().amax(dim=dim, keepdim=True)
    scale = torch.clamp(amax, min=1e-12) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def fp8_mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The control's matrix product: the weight rounded to e4m3 with one
    scale per tensor, the activations with one scale per row, the sums in
    fp32, as an fp8 GEMM computes them."""
    return _fp8(x, -1) @ _fp8(w, None)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * scale.float()


def padded_rows(vocab: int) -> int:
    """Rows of the served embedding table: the vocabulary padded to a
    multiple of 256 (the port's layout; the pad rows get no logit here)."""
    return -(-vocab // 256) * 256


@contextlib.contextmanager
def no_tf32():
    """fp32 products stay fp32 on the card inside the block."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
