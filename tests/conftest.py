"""Test env bootstrap.

Tests run on the JAX CPU backend with 8 virtual devices so sharding paths are
exercised without accelerator hardware (SURVEY.md §4 item 6), and compile
afresh: the CLI's persistent compilation cache (utils/compile_cache.py) is
off.  These settings must be in the environment before JAX is imported.
JAX_PLATFORMS is only a default, so a run on the card can choose `cuda`
(tests/test_gpu.py).
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("JAX_ENABLE_COMPILATION_CACHE", "false")
_HOST_DEVICES = "--xla_force_host_platform_device_count=8"
if _HOST_DEVICES not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "") + " " + _HOST_DEVICES
    ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from nextgenmap_tpu.index.genome import Genome  # noqa: E402
from nextgenmap_tpu.io.simulate import random_genome  # noqa: E402


@pytest.fixture(scope="session")
def toy_genome() -> Genome:
    """Small deterministic genome: two chromosomes."""
    rng = np.random.default_rng(42)
    c1 = rng.integers(0, 4, 5000).astype(np.uint8)
    c2 = rng.integers(0, 4, 3000).astype(np.uint8)
    from nextgenmap_tpu.index.genome import CHROM_GAP

    codes = np.concatenate([c1, np.full(CHROM_GAP, 4, np.uint8), c2])
    return Genome(
        codes=codes,
        names=["chr1", "chr2"],
        starts=np.array([0, 5000 + CHROM_GAP], dtype=np.int64),
        lengths=np.array([5000, 3000], dtype=np.int64),
    )


@pytest.fixture(scope="session")
def ecoli_like() -> np.ndarray:
    """200kb random genome standing in for E. coli in fast tests."""
    return random_genome(200_000, seed=7)
