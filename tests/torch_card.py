"""Fixtures of the card test files (tests/test_torch_*_card.py), which
import no JAX and run with ``--noconftest`` where the card is: the same
scene directory as tests/conftest.py's ``scenes_dir``."""

import os
import pathlib

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="session")
def scenes_dir():
    return pathlib.Path(os.environ.get("PTDN_SCENES_DIR", REPO / "scenes"))
