"""SSD scan: the port's plain version and device-dispatching wrapper against
the JAX package's Pallas kernel (interpret mode) and its oracle, plus the
Hopper kernel against its plain version on a card (``-m gpu``).

The JAX side is imported inside a fixture, so ``-m gpu`` runs where only
torch is installed.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd_scan as ssd

torch.set_num_threads(2)

# the reference sweep (tests/test_kernels.py::test_ssd_scan_sweep)
SHAPES = [
    (1, 64, 2, 16, 1, 8, 16),
    (2, 96, 4, 8, 2, 16, 32),
    (1, 50, 4, 16, 4, 8, 16),    # padding path (50 % 16 != 0)
]
# the reference sweep's tolerance: chunked against sequential sums in fp32
ATOL = 2e-3


@pytest.fixture(scope="module")
def jx():
    import jax.numpy as jnp

    from repro.kernels import ops as j_ops
    from repro.kernels import ref as j_ref
    return SimpleNamespace(jnp=jnp, ops=j_ops, ref=j_ref)


def _inputs(seed, bsz, s, h, p, g, n, with_init, a_max=8.0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((bsz, s, h, p), dtype=np.float32) * 0.5
    dt = np.log1p(np.exp(rng.standard_normal((bsz, s, h), dtype=np.float32)))
    a_log = np.log(np.linspace(1.0, a_max, h, dtype=np.float32))
    B = rng.standard_normal((bsz, s, g, n), dtype=np.float32) * 0.3
    C = rng.standard_normal((bsz, s, g, n), dtype=np.float32) * 0.3
    init = (rng.standard_normal((bsz, h, p, n), dtype=np.float32) * 0.1
            if with_init else None)
    return x, dt, a_log, B, C, init


def _np(t):
    return t.detach().float().cpu().numpy()


def _torch(arrays, device="cpu"):
    return [None if a is None else torch.from_numpy(a).to(device) for a in arrays]


@pytest.mark.parametrize("bsz,s,h,p,g,n,chunk", SHAPES)
@pytest.mark.parametrize("with_init", [False, True])
def test_ssd_scan_sweep(jx, bsz, s, h, p, g, n, chunk, with_init):
    """Twin of the reference sweep: the port's wrapper and plain version
    against the JAX wrapper (Pallas in interpret mode) and its oracle."""
    arrays = _inputs(7, bsz, s, h, p, g, n, with_init)
    jargs = [None if a is None else jx.jnp.asarray(a) for a in arrays]
    jy, jf = jx.ops.ssd_scan(*jargs[:5], chunk=chunk, init_state=jargs[5])
    ry, rf = jx.ref.ssd_scan_ref(*jargs[:5], init_state=jargs[5])

    x, dt, a_log, B, C, init = _torch(arrays)
    before = ssd.launches
    ty, tf = ops.ssd_scan(x, dt, a_log, B, C, chunk=chunk, init_state=init)
    py, pf = ref.ssd_scan_ref(x, dt, a_log, B, C, init_state=init)
    assert ssd.launches == before        # a CPU tensor never reaches the kernel
    assert ty.shape == x.shape and ty.dtype == x.dtype
    assert tf.shape == (bsz, h, p, n) and tf.dtype == torch.float32
    for got_y, got_f in ((ty, tf), (py, pf)):
        for want_y, want_f in ((jy, jf), (ry, rf)):
            np.testing.assert_allclose(_np(got_y), np.asarray(want_y), atol=ATOL)
            np.testing.assert_allclose(_np(got_f), np.asarray(want_f), atol=ATOL)


def test_ssd_scan_bf16_contract(jx):
    """bf16 x and B/C: y comes back in x's dtype, the final state in fp32,
    as the reference wrapper returns them (bf16 output rounding sets the
    tolerance)."""
    x, dt, a_log, B, C, _ = _inputs(9, 2, 40, 4, 16, 2, 16, False)
    jb = jx.jnp.bfloat16
    jy, jf = jx.ops.ssd_scan(jx.jnp.asarray(x, jb), jx.jnp.asarray(dt),
                             jx.jnp.asarray(a_log), jx.jnp.asarray(B, jb),
                             jx.jnp.asarray(C, jb), chunk=16)
    tb = torch.bfloat16
    ty, tf = ops.ssd_scan(torch.from_numpy(x).to(tb), torch.from_numpy(dt),
                          torch.from_numpy(a_log), torch.from_numpy(B).to(tb),
                          torch.from_numpy(C).to(tb), chunk=16)
    assert ty.dtype == torch.bfloat16 and tf.dtype == torch.float32
    np.testing.assert_allclose(_np(ty), np.asarray(jy, np.float32), atol=2e-2, rtol=1e-2)
    np.testing.assert_allclose(_np(tf), np.asarray(jf), atol=ATOL)


def test_kernel_wrapper_rejects_cpu_tensors():
    """The kernel's wrapper launches on CUDA tensors or raises: it has no
    CPU path of its own."""
    xdt = torch.zeros((1, 8, 2, 16))
    dta = torch.zeros((1, 8, 2))
    b = torch.zeros((1, 8, 1, 8))
    with pytest.raises(ValueError, match="CUDA"):
        ssd.ssd_scan(xdt, dta, b, b)


def _card_cases():
    """The reference sweep, then B/C in bf16 over G in {1, 2, 4}, a ragged
    S and the serving head and state sizes at a short S."""
    cases = [(shape[:6], with_init, torch.float32)
             for shape in SHAPES for with_init in (False, True)]
    cases += [((2, 96, 8, 16, g, 16), False, torch.bfloat16) for g in (1, 2, 4)]
    cases += [((2, 200, 8, 64, g, 128), True, torch.bfloat16) for g in (1, 4)]
    return cases


@pytest.mark.gpu
def test_ssd_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    for shape, with_init, bc_dtype in _card_cases():
        x, dt, a_log, B, C, init = _torch(_inputs(11, *shape, with_init), dev)
        B, C = B.to(bc_dtype), C.to(bc_dtype)
        before = ssd.launches
        got_y, got_f = ops.ssd_scan(x, dt, a_log, B, C, chunk=16, init_state=init)
        assert ssd.launches == before + 1
        want_y, want_f = ref.ssd_scan_ref(x, dt, a_log, B, C, init_state=init)
        torch.cuda.synchronize()
        what = f"{shape} init={with_init} {bc_dtype}"
        np.testing.assert_allclose(_np(got_y), _np(want_y), atol=ATOL, err_msg=what)
        np.testing.assert_allclose(_np(got_f), _np(want_f), atol=ATOL, err_msg=what)
