"""Test-suite settings: the marker for tests that need a CUDA device."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips with a reason without one")
