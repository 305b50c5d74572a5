"""The benchmark's own tests: its modules import by their plain names, as
``run.py`` imports them, from ``benchmark/``; the program from the root."""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(1, os.path.dirname(os.path.dirname(HERE)))

import pytest  # noqa: E402


@pytest.fixture(autouse=True)
def _restore_environment():
    """A cell's switches go into the environment; each test gets it back."""
    saved = dict(os.environ)
    yield
    os.environ.clear()
    os.environ.update(saved)
