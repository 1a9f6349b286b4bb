import os
import sys
from pathlib import Path

# Tests must see ONE device (the dry-run sets its own XLA_FLAGS in its own
# process); make the src layout importable regardless of how pytest is run.
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np
import pytest

try:
    # Hypothesis profiles: PR CI runs the library default; the scheduled
    # nightly deep-fuzz job selects a raised example budget with
    # ``--hypothesis-profile=nightly`` (plus REPRO_DEEP_FUZZ=1 for the
    # larger-N multi-engine differential tests).  Registration is harmless
    # when the profile is never selected.
    from hypothesis import HealthCheck, settings as _hyp_settings

    _hyp_settings.register_profile(
        "nightly", max_examples=200, deadline=None, derandomize=False,
        suppress_health_check=[HealthCheck.too_slow])
except ModuleNotFoundError:  # tier-1 collects without hypothesis installed
    pass


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips on a host without one")


@pytest.fixture
def rng():
    return np.random.RandomState(0)
