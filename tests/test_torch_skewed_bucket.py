"""Skewed bucket (paper Algorithm 1): the port's plain version and
device-dispatching wrapper against the JAX package's Pallas kernel
(interpret mode), its oracle and ``bucket_of``, exactly; plus the Hopper
kernel against its plain version on a card (``-m gpu``).

The JAX side is imported inside a fixture, so ``-m gpu`` runs where only
torch is installed.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.core.skewed_hash import bucket_of, integer_capacities
from repro_torch.kernels import ops, ref
from repro_torch.kernels import skewed_bucket as sb

# the reference sweep (tests/test_kernels.py::test_skewed_bucket_sweep)
WEIGHTS = [[1.0, 0.4], [1.0, 1.0, 1.0], [3, 4, 4], [0.5, 0.3, 0.1, 0.1]]
LENGTHS = [17, 1024, 5000]
RESOLUTION = 997
INT32_MIN, INT32_MAX = -2**31, 2**31 - 1


@pytest.fixture(scope="module")
def jx():
    import jax.numpy as jnp

    from repro.kernels import ops as j_ops
    from repro.kernels import ref as j_ref
    return SimpleNamespace(jnp=jnp, ops=j_ops, ref=j_ref)


def _hashes(seed, t, lo=0, hi=2**30):
    return np.random.default_rng(seed).integers(lo, hi, t, dtype=np.int64).astype(np.int32)


def _extreme_hashes(seed):
    """Negative hashes across the int32 range, its ends, and the
    neighbours of multiples of the hash-space size."""
    edges = [INT32_MIN, INT32_MIN + 1, INT32_MAX, INT32_MAX - 1, -1, 0, 1,
             -RESOLUTION, RESOLUTION, -RESOLUTION - 1, RESOLUTION - 1]
    return np.concatenate([np.asarray(edges, np.int32),
                           _hashes(seed, 600, INT32_MIN, INT32_MAX + 1)])


def _check_all(jx, hashes, caps):
    """ops (CPU) == plain == bucket_of == JAX kernel == JAX oracle."""
    h_t = torch.from_numpy(hashes)
    c_t = torch.from_numpy(np.asarray(caps, np.int32))
    got = ops.skewed_bucket(h_t, c_t)
    assert got.dtype == torch.int32 and got.shape == (len(hashes),)
    got = got.numpy()
    assert np.array_equal(got, ref.skewed_bucket_ref(h_t, c_t).numpy())
    assert np.array_equal(got, bucket_of(hashes, caps))
    h_j, c_j = jx.jnp.asarray(hashes), jx.jnp.asarray(caps, jx.jnp.int32)
    assert np.array_equal(got, np.asarray(jx.ops.skewed_bucket(h_j, c_j, interpret=True)))
    assert np.array_equal(got, np.asarray(jx.ref.skewed_bucket_ref(h_j, c_j)))
    return got


@pytest.mark.parametrize("weights", WEIGHTS, ids=str)
@pytest.mark.parametrize("t", LENGTHS)
def test_skewed_bucket_sweep(jx, weights, t):
    caps = integer_capacities(weights, resolution=RESOLUTION)
    got = _check_all(jx, _hashes(t, t), caps)
    assert got.min() >= 0 and got.max() < len(weights)


@pytest.mark.parametrize("caps", [[700, 297], [0, 500, 0, 497], [997, 0], [0, 0, 1]],
                         ids=str)
def test_negative_extreme_hashes_and_zero_capacities(jx, caps):
    got = _check_all(jx, _extreme_hashes(sum(caps)), np.asarray(caps))
    # a zero-capacity bucket receives nothing
    for b, c in enumerate(caps):
        assert (got == b).any() == (c > 0)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    """The kernel's wrapper launches on CUDA tensors or raises: it has no CPU
    path of its own, takes int32 hashes only, and refuses a total outside
    [1, 2**31 - 1] before any launch."""
    h = torch.zeros(8, dtype=torch.int32)
    caps = torch.tensor([3, 4], dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        sb.skewed_bucket(h, caps)
    with pytest.raises(ValueError, match="CUDA"):
        sb.launch(h, torch.cumsum(caps, 0, dtype=torch.int32))
    for dtype in (torch.int64, torch.int16, torch.float32):
        with pytest.raises(ValueError, match="int32"):
            sb.skewed_bucket(h.to(dtype), caps)
    with pytest.raises(ValueError, match="int32"):
        sb.skewed_bucket(h[::2], caps)                  # not contiguous
    for bad in ([0, 0], [5, -5], [-1, 0], [2**30, 2**30]):
        with pytest.raises(ValueError, match="sum to"):
            sb.skewed_bucket(h, torch.tensor(bad, dtype=torch.int32))


def _card_cases():
    """The reference sweep, negative and extreme hashes, and zero-capacity
    buckets."""
    cases = [(_hashes(t, t), integer_capacities(w, resolution=RESOLUTION))
             for w in WEIGHTS for t in LENGTHS]
    cases += [(_extreme_hashes(1), np.asarray(c))
              for c in ([700, 297], [0, 500, 0, 497], [997, 0])]
    return cases


@pytest.mark.gpu
def test_skewed_bucket_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    for hashes, caps in _card_cases():
        h = torch.from_numpy(hashes).to(dev)
        c = torch.from_numpy(np.asarray(caps, np.int32)).to(dev)
        before = sb.launches
        got = ops.skewed_bucket(h, c)
        assert sb.launches == before + 1
        want = ref.skewed_bucket_ref(h, c)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (len(hashes), list(caps))
        assert np.array_equal(got.cpu().numpy(), bucket_of(hashes, caps))


# --- any integer hash, any number of capacities --------------------------------------

def _wide_caps(seed, e):
    caps = np.random.default_rng(seed).integers(0, 1000, e)
    caps[np.random.default_rng(seed + 1).random(e) < 0.1] = 0     # zero capacities
    return caps.astype(np.int32)


@pytest.mark.parametrize("e", [1025, 4096])
def test_wide_capacities_match_jax(jx, e):
    """More capacities than one 1024-entry shared-memory tile of the kernel,
    some zero, so the prefix sums repeat values."""
    caps = _wide_caps(e, e)
    got = _check_all(jx, _hashes(e, 3000, INT32_MIN, INT32_MAX + 1), caps)
    assert got.min() >= 0 and got.max() < e


def test_int64_hashes_wrap_to_int32_like_the_reference(jx):
    """The reference's ``astype(jnp.int32)`` wraps a wider hash modulo 2**32;
    ``ops.skewed_bucket`` casts the same way on every device."""
    rng = np.random.default_rng(5)
    hashes = np.concatenate([np.asarray([2**31, 2**31 + 5, 2**32 + 7, -2**31 - 3, 2**40 + 1]),
                             rng.integers(2**31, 2**40, 2000),
                             rng.integers(-2**40, 2**40, 2000)]).astype(np.int64)
    for caps in (np.asarray([700, 297], np.int32), _wide_caps(9, 4096)):
        got = ops.skewed_bucket(torch.from_numpy(hashes), torch.from_numpy(caps)).numpy()
        assert np.array_equal(got, bucket_of(hashes.astype(np.int32), caps))
        want = jx.ops.skewed_bucket(jx.jnp.asarray(hashes), jx.jnp.asarray(caps),
                                    interpret=True)
        assert np.array_equal(got, np.asarray(want))


@pytest.mark.gpu
def test_skewed_bucket_wide_and_int64_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    rng = np.random.default_rng(6)
    for hashes, caps in ((rng.integers(INT32_MIN, INT32_MAX, 70_000).astype(np.int32),
                          _wide_caps(1, 4096)),
                         (rng.integers(-2**40, 2**40, 70_000), _wide_caps(2, 4096)),
                         (rng.integers(2**31, 2**40, 5000), np.asarray([700, 297], np.int32))):
        h, c = torch.from_numpy(hashes).to(dev), torch.from_numpy(caps).to(dev)
        before = sb.launches
        got = ops.skewed_bucket(h, c)
        assert sb.launches == before + 1
        assert torch.equal(got, ref.skewed_bucket_ref(h, c))
        assert np.array_equal(got.cpu().numpy(), bucket_of(hashes.astype(np.int32), caps))
