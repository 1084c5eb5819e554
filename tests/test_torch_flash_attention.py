"""Flash attention: the port's plain version and device-dispatching wrapper
against the JAX package's Pallas kernel (interpret mode) and its oracle; the
wrapper's route choice, TMA layout checks and tile arithmetic on the CPU;
and both Hopper routes against the plain version on a card (``-m gpu``).

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
    before = fa.launches, dict(fa.launches_by_route)
    out = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=True)
    assert out.shape == q.shape
    np.testing.assert_allclose(_np(out), np.asarray(want), atol=2e-5)
    np.testing.assert_allclose(_np(out), np.asarray(want_ops), atol=2e-5)
    # a CPU tensor never reaches either kernel
    assert (fa.launches, fa.launches_by_route) == before


def test_kernel_wrapper_rejects_cpu_tensors():
    """The kernel's wrapper launches on CUDA tensors or raises: it has no
    CPU path of its own."""
    q = torch.zeros((1, 2, 8, 16))
    k = torch.zeros((1, 2, 8, 16))
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention(q, k, k)


@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "wgmma"),
                                         (torch.float32, "simt")])
def test_route_is_chosen_by_dtype(dtype, route):
    assert fa.route_for(dtype) == route


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_route_rejects_other_dtypes(dtype):
    with pytest.raises(ValueError, match="not float32 or bfloat16"):
        fa.route_for(dtype)


def _strided(shape, strides, offset=0, dtype=torch.bfloat16):
    size = offset + 1 + sum((n - 1) * st for n, st in zip(shape, strides))
    return torch.zeros(size, dtype=dtype).as_strided(shape, strides, offset)


TMA_CASES = [
    # contiguous (B, H, S, D)
    ("contiguous", lambda: torch.zeros((2, 4, 64, 16), dtype=torch.bfloat16), None),
    # the model layout's head-major view: seq stride H*D, head stride D
    ("model layout", lambda: torch.zeros((2, 64, 4, 32), dtype=torch.bfloat16)
     .transpose(1, 2), None),
    # a size-1 batch is never stepped, whatever its stride
    ("size-1 batch", lambda: _strided((1, 2, 8, 16), (3, 128, 16, 1)), None),
    ("base pointer", lambda: _strided((2, 4, 64, 16), (4096, 1024, 16, 1), offset=1),
     "data_ptr"),
    ("head_dim 12", lambda: torch.zeros((1, 2, 8, 12), dtype=torch.bfloat16),
     "seq stride is 24 B"),
    ("head stride", lambda: _strided((2, 3, 8, 16), (512, 132, 16, 1)),
     "head stride is 264 B"),
    ("batch stride", lambda: _strided((2, 3, 8, 16), (388, 128, 16, 1)),
     "batch stride is 776 B"),
]


@pytest.mark.parametrize("make,want", [c[1:] for c in TMA_CASES],
                         ids=[c[0] for c in TMA_CASES])
def test_tma_layout_error(make, want):
    """The wgmma route's TMA loads need 16 B aligned pointers and (batch,
    head, seq) strides; the wrapper raises with this message instead of
    copying."""
    err = fa.tma_layout_error("q", make())
    if want is None:
        assert err is None
    else:
        assert err is not None and want in err


@pytest.mark.parametrize("head_dim,want", [(16, 83_072), (32, 83_072), (64, 83_072),
                                           (65, 164_992), (128, 164_992)])
def test_wgmma_smem_bytes(head_dim, want):
    """Q plus a two-stage K/V ring of 128-row tiles in 64-column blocks of
    128 B rows, 1 KB of alignment slack and the mbarriers; it fits one block
    per SM (227 KB)."""
    assert fa.wgmma_smem_bytes(head_dim) == want
    assert want <= 232_448


def _pallas_live_tiles(q0, bq, bk, sk, causal, window):
    """The Pallas kernel's block-level skip over its ceil(sk / bk) kv blocks."""
    live = []
    for ki in range(-(-sk // bk)):
        k0 = ki * bk
        ok = True
        if causal:
            ok = q0 + bq - 1 >= k0
        if window > 0:
            ok = ok and q0 < k0 + bk + window - 1
        if ok:
            live.append(ki)
    return live


@pytest.mark.parametrize("sq,sk", [(1, 1), (127, 127), (129, 129), (1000, 1000),
                                   (128, 256), (33, 65), (300, 40)])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 100), (False, 0),
                                           (False, 200)])
@pytest.mark.parametrize("block", [128, 64])
def test_kv_tile_range_matches_pallas_skip(sq, sk, causal, window, block):
    """Both routes visit exactly the kv tiles the Pallas kernel keeps live
    at the same block size (128 for wgmma, 64 for simt)."""
    for q0 in range(0, sq, block):
        got = list(fa.kv_tile_range(q0, sk, causal, window, block, block))
        assert got == _pallas_live_tiles(q0, block, block, sk, causal, window), q0


@pytest.mark.gpu
def test_flash_kernel_matches_plain_on_card():
    """The reference sweep through both routes: fp32 on the CUDA cores,
    bf16 on the tensor cores, each launch counted on its route."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    cases = [(s, m, dt) for s in SHAPES for m in MASKS for dt in TORCH_DTYPES]
    for (b, hq, hkv, sq, sk, d), (causal, window), dtype in cases:
        tq, tk, tv = (torch.from_numpy(a).to(dev, TORCH_DTYPES[dtype])
                      for a in _inputs(7, b, hq, hkv, sq, sk, d))
        before = fa.launches, dict(fa.launches_by_route)
        got = fa.flash_attention(tq, tk, tv, causal=causal, window=window)
        route = fa.route_for(TORCH_DTYPES[dtype])
        assert fa.launches == before[0] + 1
        assert fa.launches_by_route == {**before[1], route: before[1][route] + 1}
        want = ref.flash_attention_ref(tq, tk, tv, causal=causal, window=window)
        torch.cuda.synchronize()
        np.testing.assert_allclose(_np(got), _np(want), atol=TOL[dtype], rtol=1e-2,
                                   err_msg=f"{(b, hq, hkv, sq, sk, d)} "
                                           f"{(causal, window)} {dtype}")


# bf16 at the serving head_dim: ragged lengths around the 128-row tiles,
# GQA groups 1, 4 and 8, and a window
WGMMA_LENGTHS = [1, 127, 129, 1000]
WGMMA_HEADS = [(8, 8), (8, 2), (8, 1)]
WGMMA_MASKS = [(True, 0), (True, 100), (False, 0)]


@pytest.mark.gpu
def test_flash_wgmma_head_dim_128_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    cases = [(s, hd, m) for s in WGMMA_LENGTHS for hd in WGMMA_HEADS for m in WGMMA_MASKS]
    for s, (hq, hkv), (causal, window) in cases:
        # model layout (B, S, H, D) handed over as head-major views
        rng = np.random.default_rng(9)
        q, k, v = (torch.from_numpy(rng.standard_normal((2, s, h, 128), dtype=np.float32))
                   .to(dev, torch.bfloat16).transpose(1, 2) for h in (hq, hkv, hkv))
        before = dict(fa.launches_by_route)
        got = fa.flash_attention(q, k, v, causal=causal, window=window)
        assert fa.launches_by_route == {**before, "wgmma": before["wgmma"] + 1}
        want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        np.testing.assert_allclose(_np(got), _np(want), atol=TOL["bfloat16"], rtol=1e-2,
                                   err_msg=f"s={s} heads={(hq, hkv)} {(causal, window)}")


@pytest.mark.gpu
def test_flash_wgmma_raises_on_misaligned_input_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    k = torch.zeros((1, 2, 64, 16), dtype=torch.bfloat16, device=dev)
    q = torch.zeros(2 * 64 * 16 + 1, dtype=torch.bfloat16, device=dev)[1:].view(1, 2, 64, 16)
    before = fa.launches
    with pytest.raises(ValueError, match="16 B aligned"):
        fa.flash_attention(q, k, k)
    with pytest.raises(ValueError, match="seq stride"):
        q12 = torch.zeros((1, 2, 64, 12), dtype=torch.bfloat16, device=dev)
        fa.flash_attention(q12, q12, q12)
    assert fa.launches == before
