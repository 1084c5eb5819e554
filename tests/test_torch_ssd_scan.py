"""SSD scan: the port's plain version and device-dispatching wrapper against
the JAX package's Pallas kernel (interpret mode) and its oracle; a CPU model
of the tensor-core route's arithmetic (bf16 operands with hi/lo splits)
against both; the wrapper's routing and layout checks; and both Hopper
kernels against their plain version on a card (``-m gpu``).

The JAX side is imported inside a fixture, so ``-m gpu`` runs where only
torch is installed.
"""
import re
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
    """The kernel's wrapper launches on CUDA tensors or raises, on either
    route: it has no CPU path of its own."""
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.zeros((1, 8, 2, 16), dtype=dtype)
        dt = torch.zeros((1, 8, 2))
        a_log = torch.zeros(2)
        b = torch.zeros((1, 8, 1, 8), dtype=dtype)
        with pytest.raises(ValueError, match="CUDA"):
            ssd.ssd_scan(x, dt, a_log, b, b)


# ---------------------------------------------------------------------------
# the tensor-core route's arithmetic, modelled on the CPU


def _bf16_split(v):
    """float32 v as bf16 hi = bf16(v) and lo = bf16(v - hi), in float64."""
    hi = v.to(torch.bfloat16)
    lo = (v - hi.float()).to(torch.bfloat16)
    return hi.double(), lo.double()


def _bf16_only(v):
    return v.to(torch.bfloat16).double(), 0.0


def _route_model(x, dt, a_log, B, C, init=None, split=True, q=64):
    """The wgmma route's arithmetic (csrc/ssd_scan.cu, ssd_wgmma_kernel): 64-row
    chunks; x, B and C used as their exact bf16 values; the factors computed
    in fp32 (G = C B^T . L . dt_j, W = x . dt_j exp(cum_last - cum_j) and the
    state) rounded to bf16 hi + lo (``split``) or to bf16 alone; each product
    summed exactly (float64) and kept in fp32, as the tensor cores' fp32
    accumulators keep it. Returns (y fp32, final state fp32)."""
    bsz, s, h, p = x.shape
    rep = h // B.shape[2]
    part = _bf16_split if split else _bf16_only
    a = -torch.exp(a_log.float())
    xh = x.double().permute(0, 2, 1, 3)                             # (b, H, S, P)
    bh = B.repeat_interleave(rep, 2).double().permute(0, 2, 1, 3)   # (b, H, S, N)
    ch = C.repeat_interleave(rep, 2).double().permute(0, 2, 1, 3)
    dth = dt.float().permute(0, 2, 1)                                # (b, H, S)
    st = (torch.zeros((bsz, h, p, B.shape[3])) if init is None
          else init.float().clone())
    ys = []
    for c0 in range(0, s, q):
        sl = slice(c0, min(c0 + q, s))
        d = dth[..., sl]
        cum = torch.cumsum(d * a[:, None], -1)
        last = cum[..., -1:]
        xc, bc, cc = xh[:, :, sl], bh[:, :, sl], ch[:, :, sl]
        low = torch.ones(d.shape[-1], d.shape[-1], dtype=torch.bool).tril()
        decay = torch.exp(torch.where(low, cum[..., :, None] - cum[..., None, :], 0.0))
        cb = (cc @ bc.transpose(-1, -2)).float()
        g_hi, g_lo = part(torch.where(low, cb * decay * d[..., None, :], 0.0))
        s_hi, s_lo = part(st)
        y = (cc @ (s_hi + s_lo).transpose(-1, -2)).float() * torch.exp(cum)[..., None]
        ys.append((y.double() + (g_hi + g_lo) @ xc).float())
        w_hi, w_lo = part(xc.float() * (d * torch.exp(last - cum))[..., None])
        st = (st.double() * torch.exp(last)[..., None].double()
              + (w_hi + w_lo).transpose(-1, -2) @ bc).float()
    return torch.cat(ys, 2).permute(0, 2, 1, 3), st


def _bf16_inputs(seed, bsz, s, h, p, g, n, with_init, a_max=8.0):
    """The sweep's draws with x, B and C rounded to bf16: torch bf16 tensors,
    and the same values in float32 numpy for the JAX side."""
    x, dt, a_log, B, C, init = _inputs(seed, bsz, s, h, p, g, n, with_init, a_max)
    xb, Bb, Cb = (torch.from_numpy(v).to(torch.bfloat16) for v in (x, B, C))
    rounded = [xb.float().numpy(), dt, a_log, Bb.float().numpy(), Cb.float().numpy(), init]
    return (xb, torch.from_numpy(dt), torch.from_numpy(a_log), Bb, Cb,
            None if init is None else torch.from_numpy(init)), rounded


@pytest.mark.parametrize("bsz,s,h,p,g,n,chunk", SHAPES)
@pytest.mark.parametrize("with_init", [False, True])
def test_wgmma_route_model_matches_jax_and_oracle(jx, bsz, s, h, p, g, n, chunk, with_init):
    """The route's split-bf16 arithmetic on bf16 x and B/C against the JAX
    wrapper (Pallas in interpret mode) and its oracle, given the same values
    in fp32, at the reference sweep's tolerance."""
    targs, rounded = _bf16_inputs(7, bsz, s, h, p, g, n, with_init)
    jargs = [None if v is None else jx.jnp.asarray(v) for v in rounded]
    jy, jf = jx.ops.ssd_scan(*jargs[:5], chunk=chunk, init_state=jargs[5])
    ry, rf = jx.ref.ssd_scan_ref(*jargs[:5], init_state=jargs[5])
    my, mf = _route_model(*targs[:5], init=targs[5])
    assert my.shape == (bsz, s, h, p) and mf.shape == (bsz, h, p, n)
    for want_y, want_f in ((jy, jf), (ry, rf)):
        np.testing.assert_allclose(_np(my), np.asarray(want_y), atol=ATOL)
        np.testing.assert_allclose(_np(mf), np.asarray(want_f), atol=ATOL)


SERVING_LIKE = (1, 1024, 8, 64, 1, 128)   # H 8, P 64, N 128 of mamba2-2.7b, S 1024


def _serving_like():
    targs, _ = _bf16_inputs(13, *SERVING_LIKE, False, a_max=16.0)
    want = ref.ssd_scan_ref(targs[0].float(), *targs[1:5])
    return targs, want


def test_wgmma_route_model_at_serving_size():
    """At mamba2-2.7b's head and state sizes over 16 chunks, the split
    scheme stays inside the reference's tolerance of the fp32 sequential
    recurrence."""
    targs, (want_y, want_f) = _serving_like()
    my, mf = _route_model(*targs[:5])
    np.testing.assert_allclose(_np(my), _np(want_y), atol=ATOL)
    np.testing.assert_allclose(_np(mf), _np(want_f), atol=ATOL)


def test_wgmma_route_model_needs_the_splits():
    """The same inputs with the fp32 factors rounded to bf16 alone miss the
    tolerance: the hi/lo splits are what the route's accuracy rests on."""
    targs, (want_y, _) = _serving_like()
    my, _ = _route_model(*targs[:5], split=False)
    assert float((my - want_y).abs().max()) > ATOL


# ---------------------------------------------------------------------------
# the wrapper's routing and layout checks (no card needed)


def test_route_for_picks_by_dtype():
    assert ssd.route_for(torch.bfloat16) == "wgmma"
    assert ssd.route_for(torch.float32) == "simt"
    with pytest.raises(ValueError, match="float16"):
        ssd.route_for(torch.float16)


def _model_views(bsz=2, s=16, h=4, p=16, g=1, n=16, extra=0):
    """x, dt, a_log, B, C as the model hands them over: x, B and C strided
    views of one (batch, S, H P + 2 G N + extra) bf16 conv output."""
    xbc = torch.zeros((bsz, s, h * p + 2 * g * n + extra), dtype=torch.bfloat16)
    x, B, C = torch.split(xbc[..., :h * p + 2 * g * n], [h * p, g * n, g * n], dim=-1)
    return (x.reshape(bsz, s, h, p), torch.zeros((bsz, s, h)), torch.zeros(h),
            B.reshape(bsz, s, g, n), C.reshape(bsz, s, g, n))


def test_wgmma_layout_accepts_the_models_views():
    x, dt, a_log, B, C = _model_views()
    assert not x.is_contiguous() and x.stride(1) == 4 * 16 + 2 * 16
    assert ssd.wgmma_layout_error(x, dt, a_log, B, C) is None


def _bad_layout(case):
    x, dt, a_log, B, C = _model_views()
    if case == "p_too_wide":
        x = torch.zeros((2, 16, 4, 72), dtype=torch.bfloat16)
    elif case == "p_not_multiple":
        x = torch.zeros((2, 16, 4, 12), dtype=torch.bfloat16)
    elif case == "n_too_wide":
        B = C = torch.zeros((2, 16, 1, 136), dtype=torch.bfloat16)
    elif case == "unaligned_pointer":
        x = torch.zeros((2, 16, 4, 24), dtype=torch.bfloat16)[..., 1:17]
    elif case == "seq_stride":
        x = _model_views(extra=4)[0]              # rows of 100 bf16 = 200 B
    elif case == "fp32_b":
        B = B.float()
    elif case == "bf16_dt":
        dt = dt.to(torch.bfloat16)
    elif case == "strided_last_dim":
        x = torch.zeros((2, 16, 4, 32), dtype=torch.bfloat16)[..., ::2]
    elif case == "a_log_shape":
        a_log = torch.zeros(3)
    return x, dt, a_log, B, C


@pytest.mark.parametrize("case,match", [
    ("p_too_wide", "head dim P 72"), ("p_not_multiple", "head dim P 12"),
    ("n_too_wide", "state dim N 136"), ("unaligned_pointer", "not 16 B aligned"),
    ("seq_stride", "seq stride is 200 B"), ("fp32_b", "B is torch.float32"),
    ("bf16_dt", "dt is torch.bfloat16"), ("strided_last_dim", "not contiguous"),
    ("a_log_shape", "a_log must be"),
])
def test_wgmma_layout_rejects(case, match):
    """Inputs the tensor-core route cannot read where they lie are named,
    so the wrapper raises instead of copying or switching route."""
    err = ssd.wgmma_layout_error(*_bad_layout(case))
    assert err is not None and re.search(match, err), err


# ---------------------------------------------------------------------------
# on the card


def _card_cases():
    """The reference sweep, then B/C in bf16 over G in {1, 2, 4}, a ragged
    S and the serving head and state sizes at a short S, and 640 (batch,
    head) items: more than twice the wgmma route's 2 x 132 consumer slots on
    an H100, so each consumer warpgroup runs several items and, with bf16 y,
    frees a stage across an item boundary."""
    cases = [(shape[:6], with_init, torch.float32)
             for shape in SHAPES for with_init in (False, True)]
    cases += [((2, 96, 8, 16, g, 16), False, torch.bfloat16) for g in (1, 2, 4)]
    cases += [((2, 200, 8, 64, g, 128), True, torch.bfloat16) for g in (1, 4)]
    cases += [((8, 130, 80, 64, 1, 128), True, torch.bfloat16)]
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
        before = dict(ssd.launches_by_route)
        got_y, got_f = ops.ssd_scan(x, dt, a_log, B, C, chunk=16, init_state=init)
        assert ssd.launches_by_route == {**before, "simt": before["simt"] + 1}
        want_y, want_f = ref.ssd_scan_ref(x, dt, a_log, B, C, init_state=init)
        torch.cuda.synchronize()
        what = f"{shape} init={with_init} {bc_dtype}"
        np.testing.assert_allclose(_np(got_y), _np(want_y), atol=ATOL, err_msg=what)
        np.testing.assert_allclose(_np(got_f), _np(want_f), atol=ATOL, err_msg=what)


@pytest.mark.gpu
def test_ssd_wgmma_route_matches_plain_on_card():
    """bf16 x, B and C through the tensor-core route: y in fp32 and the state
    at the sweep's tolerance against the plain version on the same values,
    y in bf16 against the plain y rounded to bf16; then the model's strided
    views of one conv output. Every launch counted on ``wgmma``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    cases = [(shape, with_init) for shape, with_init, _ in _card_cases()]
    for shape, with_init in cases:
        x, dt, a_log, B, C, init = _torch(_inputs(17, *shape, with_init), dev)
        x, B, C = x.bfloat16(), B.bfloat16(), C.bfloat16()
        before = dict(ssd.launches_by_route)
        y32, f32 = ssd.ssd_scan(x, dt, a_log, B, C, init_state=init, y_dtype=torch.float32)
        y16, f16 = ops.ssd_scan(x, dt, a_log, B, C, chunk=16, init_state=init)
        assert ssd.launches_by_route == {**before, "wgmma": before["wgmma"] + 2}
        want_y, want_f = ref.ssd_scan_ref(x.float(), dt, a_log, B, C, init_state=init)
        torch.cuda.synchronize()
        what = f"{shape} init={with_init} bf16 x"
        assert y16.dtype == torch.bfloat16 and f16.dtype == torch.float32
        np.testing.assert_allclose(_np(y32), _np(want_y), atol=ATOL, err_msg=what)
        np.testing.assert_allclose(_np(f32), _np(want_f), atol=ATOL, err_msg=what)
        np.testing.assert_allclose(_np(y16), _np(want_y.bfloat16()), atol=2e-2, rtol=1e-2,
                                   err_msg=what)
        np.testing.assert_allclose(_np(f16), _np(want_f), atol=ATOL, err_msg=what)
    x, dt, a_log, B, C = (t.to(dev) for t in _model_views(bsz=2, s=100, h=8, p=64, n=128))
    gen = torch.Generator(device=dev).manual_seed(3)
    for t, scale in ((x, 0.5), (B, 0.3), (C, 0.3)):
        t.copy_(torch.randn(t.shape, generator=gen, device=dev) * scale)
    dt.copy_(torch.nn.functional.softplus(torch.randn(dt.shape, generator=gen, device=dev)))
    a_log.copy_(torch.log(torch.linspace(1.0, 16.0, 8, device=dev)))
    got_y, got_f = ssd.ssd_scan(x, dt, a_log, B, C, y_dtype=torch.float32)
    want_y, want_f = ref.ssd_scan_ref(x.float(), dt, a_log, B, C)
    np.testing.assert_allclose(_np(got_y), _np(want_y), atol=ATOL)
    np.testing.assert_allclose(_np(got_f), _np(want_f), atol=ATOL)
