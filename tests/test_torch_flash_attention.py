"""Flash attention: the port's plain version and device-dispatching wrapper
against the JAX package's Pallas kernel (interpret mode) and its oracle,
plus the Hopper kernel against its plain version on a card (``-m gpu``).

The JAX side is imported inside a fixture, so ``-m gpu`` runs where only
torch is installed.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref

torch.set_num_threads(2)

SHAPES = [
    (1, 2, 2, 64, 64, 16),
    (2, 4, 2, 96, 96, 32),      # GQA + non-128 seq (padding path)
    (1, 8, 1, 128, 256, 64),    # MQA, cross lengths
    (1, 2, 2, 33, 65, 16),      # ragged padding
]
MASKS = [(True, 0), (True, 24), (False, 0)]
# same tolerances as tests/test_kernels.py: bf16 output rounding dominates
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(scope="module")
def jx():
    import jax.numpy as jnp

    from repro.kernels import ops as j_ops
    from repro.kernels import ref as j_ref
    from repro.kernels.flash_attention import flash_attention as j_kernel
    return SimpleNamespace(jnp=jnp, ops=j_ops, ref=j_ref, kernel=j_kernel)


def _inputs(seed, b, hq, hkv, sq, sk, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, sq, d), dtype=np.float32),
            rng.standard_normal((b, hkv, sk, d), dtype=np.float32),
            rng.standard_normal((b, hkv, sk, d), dtype=np.float32))


def _np(t):
    return t.detach().float().cpu().numpy()


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d", SHAPES)
@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_sweep(jx, b, hq, hkv, sq, sk, d, causal, window, dtype):
    """Every case the reference sweep runs, plus the causal cross-length
    cases it skips: no query row is fully masked in any of them."""
    arrays = _inputs(7, b, hq, hkv, sq, sk, d)
    jdt = getattr(jx.jnp, dtype)
    jq, jk, jv = (jx.jnp.asarray(a, jdt) for a in arrays)
    want_kernel = np.asarray(jx.kernel(jq, jk, jv, causal=causal, window=window,
                                       block_q=32, block_k=32, interpret=True),
                             np.float32)
    want_ref = np.asarray(jx.ref.flash_attention_ref(jq, jk, jv, causal=causal,
                                                     window=window), np.float32)

    tq, tk, tv = (torch.from_numpy(a).to(TORCH_DTYPES[dtype]) for a in arrays)
    plain = ref.flash_attention_ref(tq, tk, tv, causal=causal, window=window)
    via_ops = ops.flash_attention(tq.transpose(1, 2), tk.transpose(1, 2),
                                  tv.transpose(1, 2), causal=causal,
                                  window=window).transpose(1, 2)
    assert plain.dtype == tq.dtype and plain.shape == tq.shape
    for got in (plain, via_ops):
        for want in (want_kernel, want_ref):
            np.testing.assert_allclose(_np(got), want, atol=TOL[dtype], rtol=1e-2)


def test_flash_ops_wrapper_model_layout(jx):
    rng = np.random.default_rng(8)
    q = rng.standard_normal((2, 64, 4, 32), dtype=np.float32)
    k = rng.standard_normal((2, 64, 2, 32), dtype=np.float32)
    v = rng.standard_normal((2, 64, 2, 32), dtype=np.float32)
    jnp = jx.jnp
    want = jnp.swapaxes(jx.ref.flash_attention_ref(
        jnp.swapaxes(q, 1, 2), jnp.swapaxes(k, 1, 2), jnp.swapaxes(v, 1, 2),
        causal=True), 1, 2)
    want_ops = jx.ops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), causal=True,
                                      block_q=32, block_k=32)
    before = fa.launches
    out = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=True)
    assert out.shape == q.shape
    np.testing.assert_allclose(_np(out), np.asarray(want), atol=2e-5)
    np.testing.assert_allclose(_np(out), np.asarray(want_ops), atol=2e-5)
    assert fa.launches == before        # a CPU tensor never reaches the kernel


def test_kernel_wrapper_rejects_cpu_tensors():
    """The kernel's wrapper launches on CUDA tensors or raises: it has no
    CPU path of its own."""
    q = torch.zeros((1, 2, 8, 16))
    k = torch.zeros((1, 2, 8, 16))
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention(q, k, k)


@pytest.mark.gpu
def test_flash_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    cases = [(s, m, dt) for s in SHAPES for m in MASKS for dt in TORCH_DTYPES]
    for (b, hq, hkv, sq, sk, d), (causal, window), dtype in cases:
        tq, tk, tv = (torch.from_numpy(a).to(dev, TORCH_DTYPES[dtype])
                      for a in _inputs(7, b, hq, hkv, sq, sk, d))
        before = fa.launches
        got = fa.flash_attention(tq, tk, tv, causal=causal, window=window)
        assert fa.launches == before + 1
        want = ref.flash_attention_ref(tq, tk, tv, causal=causal, window=window)
        torch.cuda.synchronize()
        np.testing.assert_allclose(_np(got), _np(want), atol=TOL[dtype], rtol=1e-2,
                                   err_msg=f"{(b, hq, hkv, sq, sk, d)} "
                                           f"{(causal, window)} {dtype}")
