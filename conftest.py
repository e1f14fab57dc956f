"""Marks the tests of SLOW `slow`, so that the tier-1 run (`pytest tests/
-m 'not slow'`, ROADMAP.md "Tier-1 verify") leaves them out; run them with
`pytest tests/ -m slow`."""
import pytest

# Node ids from the repo's root. The JAX package's data-parallel Trainer
# trained through densify: alone it takes over half of the tier-1 run's
# time limit (ROADMAP.md, Tier-1 budget, PR 20).
SLOW = ("tests/test_parallel.py::"
        "test_trainer_data_parallel_converges_like_single",)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: left out of the tier-1 run (-m 'not slow'); run "
        "with -m slow")


@pytest.hookimpl(tryfirst=True)
def pytest_collection_modifyitems(items):
    """Runs before `-m` selects, so the mark counts there."""
    for item in items:
        if item.nodeid in SLOW:
            item.add_marker(pytest.mark.slow)
