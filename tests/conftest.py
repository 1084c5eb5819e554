import os

# smoke tests and benches must see ONE device (the dry-run sets its own
# 512-device flag in-process); keep any user XLA_FLAGS out of the way
os.environ.setdefault("JAX_PLATFORMS", "cpu")

try:
    from hypothesis import HealthCheck, settings
except ModuleNotFoundError:
    # Clean containers ship without hypothesis. Install a minimal stand-in
    # that covers the subset this suite uses (given + floats/integers/lists/
    # booleans/sampled_from/just/tuples strategies — tuples and sampled_from
    # are exercised by the randomized multi-stage differential tests in
    # test_engine.py, and the fault differential suites in test_faults.py
    # ride the same integer-seed pattern — plus profile registration as
    # no-ops) so collection
    # and the property tests still run: each @given test executes a fixed
    # number of deterministic pseudo-random examples instead of being
    # skipped.  Both branches are continuously exercised: the py3.12 leg of
    # .github/workflows/ci.yml installs the real hypothesis while the
    # py3.10 leg (and this container) runs the stub, so a strategy drifting
    # outside the stub's subset fails CI rather than lingering.  RETIRE
    # CONDITION: delete this whole except-branch the day the container
    # image bakes hypothesis in (i.e. the import above stops failing on a
    # clean container) — tracked as a ROADMAP.md open item; the CI matrix
    # leg keeps covering the real library either way.
    import random
    import sys
    import types
    import zlib

    _MAX_EXAMPLES = 25

    class _Strategy:
        def __init__(self, draw):
            self.draw = draw

    def _floats(min_value, max_value):
        return _Strategy(lambda r: r.uniform(min_value, max_value))

    def _integers(min_value, max_value):
        return _Strategy(lambda r: r.randint(min_value, max_value))

    def _lists(elements, min_size=0, max_size=None):
        hi = max_size if max_size is not None else min_size + 10

        def draw(r):
            return [elements.draw(r) for _ in range(r.randint(min_size, hi))]

        return _Strategy(draw)

    def _booleans():
        return _Strategy(lambda r: r.random() < 0.5)

    def _sampled_from(seq):
        pool = list(seq)
        return _Strategy(lambda r: r.choice(pool))

    def _just(value):
        return _Strategy(lambda r: value)

    def _tuples(*strategies):
        return _Strategy(lambda r: tuple(s.draw(r) for s in strategies))

    def _given(**named):
        def deco(fn):
            # NB: no functools.wraps — pytest would follow __wrapped__ to the
            # original signature and try to resolve the strategy names as
            # fixtures; the wrapper must present a bare () signature.
            def wrapper(*args, **kwargs):
                # str hash() is per-process randomized; crc32 keeps the
                # drawn examples deterministic across runs
                base = zlib.crc32(fn.__qualname__.encode())
                for example in range(_MAX_EXAMPLES):
                    rng = random.Random(base + example)
                    drawn = {k: s.draw(rng) for k, s in named.items()}
                    fn(*args, **drawn, **kwargs)

            wrapper.__name__ = fn.__name__
            wrapper.__qualname__ = fn.__qualname__
            wrapper.__doc__ = fn.__doc__
            wrapper.__module__ = fn.__module__
            return wrapper

        return deco

    class _HealthCheck:
        too_slow = "too_slow"
        filter_too_much = "filter_too_much"

    class _Settings:
        @staticmethod
        def register_profile(name, **kwargs):
            pass

        @staticmethod
        def load_profile(name):
            pass

    _st = types.ModuleType("hypothesis.strategies")
    _st.floats = _floats
    _st.integers = _integers
    _st.lists = _lists
    _st.booleans = _booleans
    _st.sampled_from = _sampled_from
    _st.just = _just
    _st.tuples = _tuples

    _hyp = types.ModuleType("hypothesis")
    _hyp.given = _given
    _hyp.settings = _Settings
    _hyp.HealthCheck = _HealthCheck
    _hyp.strategies = _st
    sys.modules["hypothesis"] = _hyp
    sys.modules["hypothesis.strategies"] = _st

    from hypothesis import HealthCheck, settings

settings.register_profile(
    "ci", max_examples=25, deadline=None,
    suppress_health_check=[HealthCheck.too_slow])
# the nightly chaos leg (.github/workflows/ci.yml) runs the randomized
# differential suites under the real hypothesis with a date-derived
# --hypothesis-seed and a deeper example budget; select it with
# HYPOTHESIS_PROFILE=chaos (stub profiles are no-ops, so the env var is
# harmless on clean containers)
settings.register_profile(
    "chaos", max_examples=200, deadline=None,
    suppress_health_check=[HealthCheck.too_slow])
settings.load_profile(os.environ.get("HYPOTHESIS_PROFILE", "ci"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips without one, run on the "
                   "card with -m gpu")
