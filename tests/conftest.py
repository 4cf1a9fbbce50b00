import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.models import lm

try:
    # CI property runs must be reproducible: a derandomized profile is
    # registered and active by default, so every run replays the same
    # example sequence (no flaky shrink chains, failures reproduce from
    # the printed blob). Set HYPOTHESIS_PROFILE=dev locally to explore
    # fresh random examples, or HYPOTHESIS_SEED=<n> to pin a specific
    # non-derandomized draw sequence.
    import random

    from hypothesis import settings

    _seed = os.environ.get("HYPOTHESIS_SEED")
    settings.register_profile("ci", derandomize=_seed is None,
                              deadline=None, print_blob=True)
    settings.register_profile("dev", deadline=None)
    if _seed is not None:
        random.seed(int(_seed))      # hypothesis's entropy fallback
    settings.load_profile(os.environ.get("HYPOTHESIS_PROFILE", "ci"))
except ImportError:                  # fast tier: no hypothesis installed
    pass


@pytest.fixture(autouse=True, scope="module")
def _bound_live_executables():
    """Drop compiled programs between test modules. A full-suite process
    otherwise accumulates every module's jitted engines plus the eager
    dense-oracle scans; past a few hundred live XLA:CPU executables a
    late compile segfaults inside backend_compile. Modules don't share
    engines, so per-module clearing only re-pays the handful of common
    oracle programs."""
    yield
    jax.clear_caches()


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def trace_on():
    """The test runs inside the port's ``trace.recording()``, so every
    kernel call it makes is recorded and its launch counters move;
    yields the records."""
    from repro_torch.core import trace
    with trace.recording() as records:
        yield records


def manual_greedy(params, cfg, prompt, n_new, max_len):
    """Dense-cache greedy decode: the serving engines' parity oracle."""
    logits, cache = lm.prefill(params, prompt[None], cfg, alloc=max_len)
    toks = [int(jnp.argmax(logits[0]))]
    lengths = jnp.asarray([prompt.shape[0]], jnp.int32)
    for _ in range(n_new - 1):
        lg, cache = lm.decode_step(
            params, cache, jnp.asarray([[toks[-1]]], jnp.int32),
            lengths, cfg)
        toks.append(int(jnp.argmax(lg[0])))
        lengths = lengths + 1
    return toks
