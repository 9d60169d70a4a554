"""Shared pytest config. NOTE: no XLA device-count flags here — smoke tests
run on the single real CPU device; distributed tests spawn subprocesses."""
import pytest


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "slow: long-running integration tests")
    config.addinivalue_line("markers", "gpu: needs a CUDA card; skips without one")


def pytest_addoption(parser):
    parser.addoption("--skip-slow", action="store_true", default=False,
                     help="skip tests marked slow")


def pytest_collection_modifyitems(config, items):
    if config.getoption("--skip-slow"):
        skip = pytest.mark.skip(reason="--skip-slow")
        for item in items:
            if "slow" in item.keywords:
                item.add_marker(skip)
