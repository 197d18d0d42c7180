import os
import sys
import time

# NOTE: no XLA_FLAGS here by design — smoke tests and benches must see the
# single real device; only launch/dryrun.py (its own process) forces 512.
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import pytest


@pytest.fixture(scope="session")
def rng():
    import jax
    return jax.random.PRNGKey(0)


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running integration test")
    config.addinivalue_line("markers", "cuda: needs an NVIDIA card of compute "
                            "capability 9.0 and nvcc; skips without them")


@pytest.fixture(autouse=True)
def _fast_lane_budget(request):
    """Fail any non-`slow` test that exceeds the per-test wall budget.

    Enabled by setting FAST_TEST_BUDGET_S (CI runs the smoke lane with
    30): a test too heavy for the fast lane must either get faster or be
    marked `slow`, instead of silently eroding the lane."""
    budget = float(os.environ.get("FAST_TEST_BUDGET_S", "0") or 0)
    t0 = time.perf_counter()
    yield
    if not budget or "slow" in request.keywords:
        return
    took = time.perf_counter() - t0
    if took > budget:
        pytest.fail(f"{request.node.nodeid} took {took:.1f}s — over the "
                    f"{budget:.0f}s fast-lane budget; speed it up or mark "
                    f"it @pytest.mark.slow", pytrace=False)
