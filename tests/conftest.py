"""Registers the marker of tests that need a CUDA GPU."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA GPU; skips with a reason without one")
