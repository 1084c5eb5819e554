"""Port layers against the JAX package's layers, fp32, same numpy inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jl
from repro_torch.models import layers as tl

torch.set_num_threads(2)

ATOL = 1e-6     # fp32: summation order and last-ulp transcendental differences


def _rng(seed=0):
    return np.random.default_rng(seed)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=atol,
                               rtol=1e-6)


def test_rmsnorm():
    rng = _rng(1)
    x = rng.standard_normal((2, 5, 32), dtype=np.float32) * 3.0
    scale = rng.standard_normal(32, dtype=np.float32)
    _close(tl.rmsnorm({"scale": torch.from_numpy(scale)}, torch.from_numpy(x), 1e-5),
           jl.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x), 1e-5))


def test_rmsnorm_keeps_bf16_and_computes_in_fp32():
    rng = _rng(2)
    x = rng.standard_normal((3, 64), dtype=np.float32)
    scale = np.ones(64, np.float32)
    got = tl.rmsnorm({"scale": torch.from_numpy(scale)},
                     torch.from_numpy(x).to(torch.bfloat16))
    want = jl.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x, jnp.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


@pytest.mark.parametrize("style", ["full", "half", "none"])
def test_apply_rope(style):
    rng = _rng(3)
    x = rng.standard_normal((2, 7, 3, 16), dtype=np.float32)
    pos = np.broadcast_to(np.arange(7, dtype=np.int32) * 3, (2, 7)).copy()
    got = tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10_000.0, style)
    want = jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0, style)
    _close(got, want)


def test_rope_rotates_interleaved_pairs():
    """Position 1 with one frequency pair: (x0, x1) rotates by 1 radian."""
    x = torch.tensor([[[[1.0, 0.0]]]])
    out = tl.apply_rope(x, torch.tensor([[1]]), 10_000.0, "full")
    np.testing.assert_allclose(out.numpy().ravel(), [np.cos(1.0), np.sin(1.0)],
                               atol=1e-7)


@pytest.mark.parametrize("glu,act", [(True, "silu"), (False, "gelu"), (True, "gelu")])
def test_mlp_apply(glu, act):
    rng = _rng(4)
    x = rng.standard_normal((2, 5, 16), dtype=np.float32)
    p = {"w_up": rng.standard_normal((16, 24), dtype=np.float32) * 0.25,
         "w_down": rng.standard_normal((24, 16), dtype=np.float32) * 0.2}
    if glu:
        p["w_gate"] = rng.standard_normal((16, 24), dtype=np.float32) * 0.25
    got = tl.mlp_apply({k: torch.from_numpy(v) for k, v in p.items()},
                       torch.from_numpy(x), act)
    want = jl.mlp_apply({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), act)
    _close(got, want)


def test_embed_unembed():
    rng = _rng(5)
    table = rng.standard_normal((40, 16), dtype=np.float32)
    toks = rng.integers(0, 40, (2, 6)).astype(np.int32)
    x = rng.standard_normal((2, 6, 16), dtype=np.float32)
    tp, jp = {"table": torch.from_numpy(table)}, {"table": jnp.asarray(table)}
    _close(tl.embed(tp, torch.from_numpy(toks).long()), jl.embed(jp, jnp.asarray(toks)))
    _close(tl.unembed(tp, torch.from_numpy(x)), jl.unembed(jp, jnp.asarray(x)))


def test_init_shapes_and_stds_match_reference():
    """Only shapes and standard deviations can match (different RNGs)."""
    gen = torch.Generator().manual_seed(0)
    p = tl.mlp_init(gen, 256, 512, True, dtype=torch.float32)
    e = tl.embedding_init(gen, 300, 256, dtype=torch.float32)
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        "w_up": (256, 512), "w_down": (512, 256), "w_gate": (256, 512)}
    assert tuple(e["table"].shape) == (300, 256)
    for w, fan_in in ((p["w_up"], 256), (p["w_down"], 512), (e["table"], 256)):
        assert abs(float(w.std()) * np.sqrt(fan_in) - 1.0) < 0.02
    assert not any(t.requires_grad for t in p.values())
    norm = tl.rmsnorm_init(8)
    assert norm["scale"].dtype == torch.float32 and bool((norm["scale"] == 1).all())
