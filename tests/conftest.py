"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Sharding correctness is validated on virtual CPU devices; the four-card
path runs on GPUs through ``python chip_smoke.py --cards 4``.  Tests marked
``gpu`` need a CUDA card and skip elsewhere.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

# Also set through the config API, in case JAX was imported first.  A run
# on the card selects it explicitly (JAX_PLATFORMS=cuda, see chip_smoke.py).
import jax

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

import pathlib

import pytest

DATA_DIR = pathlib.Path(__file__).parent / "data"


@pytest.fixture(scope="session")
def data_dir() -> pathlib.Path:
    return DATA_DIR
