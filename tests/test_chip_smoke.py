"""chip_smoke.py on the CPU: it refuses to run, and --multi picks its phases.

The script's phases run only on the card; here it must fail loudly and
print no result line.
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

import chip_smoke

REPO = Path(__file__).resolve().parents[1]


def _run(script: Path, cwd: Path) -> subprocess.CompletedProcess:
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _assert_refused(p: subprocess.CompletedProcess, why: str) -> None:
    assert p.returncode != 0
    assert why in p.stdout + p.stderr
    assert '"ok"' not in p.stdout


def test_refuses_cpu():
    _assert_refused(_run(REPO / "chip_smoke.py", REPO), "no GPU")


def test_refuses_outside_checkout(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path)
    _assert_refused(_run(tmp_path / "chip_smoke.py", tmp_path),
                    "nextgenmap_tpu")


@pytest.mark.parametrize("multi,names", [
    (False, ["0 environment", "1 gpu tests", "2 xla timings", "3 main path"]),
    (True, ["0 environment", "four-card meshes"]),
])
def test_multi_selects_only_four_card_phases(multi, names):
    assert [n for n, _ in chip_smoke.phases(multi)] == names


def test_truth_counts(tmp_path):
    sam = tmp_path / "t.sam"
    sam.write_text("".join([
        "@SQ\tSN:chr20\tLN:1000\n",
        "simread_0_99_0\t0\tchr20\t101\t60\t*\n",     # right
        "simread_1_200_1\t16\tchr20\t300\t60\t*\n",   # 99 bp off
        "simread_2_50_1\t0\tchr20\t51\t60\t*\n",      # wrong strand
        "simread_3_7_0\t4\t*\t0\t0\t*\n",             # unmapped
        "simread_0_99_0\t256\tchr20\t500\t0\t*\n",    # secondary: skipped
    ]))
    assert chip_smoke.truth_counts(str(sam), paired=False) == (4, 3, 1)
    pe = tmp_path / "p.sam"
    pe.write_text("".join([
        "simpair_0_10_400\t99\tchr20\t12\t60\t*\n",   # mate 1 fwd at 10
        "simpair_0_10_400\t147\tchr20\t401\t60\t*\n",  # mate 2 rev at 400
    ]))
    assert chip_smoke.truth_counts(str(pe), paired=True) == (2, 2, 2)


@pytest.mark.parametrize("multi", [False, True])
def test_phases_rehearse_on_cpu(monkeypatch, tmp_path, multi):
    """Phase 3 and the four-card phase, driven on the CPU's virtual devices
    at a tiny size: the CLI cases, truth counts and SAM comparisons run end
    to end (the card's compiler and speed are not tested here)."""
    monkeypatch.setattr(chip_smoke, "WORK", str(tmp_path / "work"))
    sizes = chip_smoke.Sizes(genome=400_000, se_reads=256, pe_pairs=128,
                             long_reads=32)
    ctx = chip_smoke.Ctx(sizes, seed=1, multi=multi)
    (chip_smoke.phase_multi if multi else chip_smoke.phase_main_path)(ctx)
