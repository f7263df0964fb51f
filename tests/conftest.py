"""Test harness setup: src/ on the path, marker registration, and a
deterministic fallback shim for the OPTIONAL ``hypothesis`` dependency.

``hypothesis`` is an optional dev dependency (see EXPERIMENTS.md §Testing):
when installed, the property tests run under the real engine with shrinking;
when absent, the shim below registers a minimal stand-in in ``sys.modules``
*before* test modules are collected, so ``from hypothesis import given,
settings, strategies as st`` keeps working.  The stand-in runs each property
deterministically on the strategy bounds plus seeded random draws — weaker
than real hypothesis, but it keeps the full suite collectable and the
properties exercised in minimal environments.
"""
import functools
import inspect
import os
import sys
import types

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running end-to-end test (paper-scale params)")
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips itself when none is present")


try:
    import hypothesis  # noqa: F401
except ModuleNotFoundError:
    import numpy as _np

    class _IntStrategy:
        """Closed-interval integer strategy: bounds first, then seeded draws."""

        def __init__(self, lo, hi):
            self.lo, self.hi = int(lo), int(hi)

        def example(self, rng, i):
            if i == 0:
                return self.lo
            if i == 1:
                return self.hi
            return int(rng.integers(self.lo, self.hi + 1))

    def _integers(min_value=0, max_value=None):
        if max_value is None:
            max_value = 2 ** 31
        return _IntStrategy(min_value, max_value)

    def _given(**strategies):
        def deco(fn):
            @functools.wraps(fn)
            def wrapper(*args, **kwargs):
                n = getattr(wrapper, "_stub_max_examples", 10)
                rng = _np.random.default_rng(0x5EED)
                for i in range(n):
                    ex = {k: s.example(rng, i) for k, s in strategies.items()}
                    fn(*args, **kwargs, **ex)
            # strategy-bound params are filled by the runner above — hide them
            # from pytest's fixture resolution (wraps copies __wrapped__, and
            # inspect.signature would otherwise surface the original params)
            del wrapper.__wrapped__
            wrapper.__signature__ = inspect.Signature()
            return wrapper
        return deco

    def _settings(max_examples=None, deadline=None, **_ignored):
        def deco(fn):
            if max_examples is not None:
                fn._stub_max_examples = int(max_examples)
            return fn
        return deco

    _st = types.ModuleType("hypothesis.strategies")
    _st.integers = _integers
    _hyp = types.ModuleType("hypothesis")
    _hyp.given = _given
    _hyp.settings = _settings
    _hyp.strategies = _st
    _hyp.__stub__ = True  # let tests detect the fallback if they care
    sys.modules["hypothesis"] = _hyp
    sys.modules["hypothesis.strategies"] = _st
