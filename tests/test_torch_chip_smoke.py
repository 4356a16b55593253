"""chip_smoke.py without a card: it refuses to run, and its model writer
plus main-path phase work on the CPU, so the script does not rot between
runs on the card."""

import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import chip_smoke

torch.set_num_threads(1)
ROOT = Path(chip_smoke.__file__).parent


def _run(script, cwd):
    return subprocess.run([sys.executable, str(script)], cwd=cwd,
                          capture_output=True, text=True, timeout=120,
                          env={"CUDA_VISIBLE_DEVICES": "",
                               "PATH": "/usr/bin:/bin"})


def test_refuses_without_cuda():
    res = _run(ROOT / "chip_smoke.py", ROOT)
    assert res.returncode != 0
    assert "CUDA is not available" in res.stderr
    assert '"ok"' not in res.stdout


def test_refuses_alone_in_a_directory(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = _run(tmp_path / "chip_smoke.py", tmp_path)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def _main_path_on_cpu(tmp_path, scheme):
    # 30 s leaves up to 1 s of the last hydrological chunk unapplied
    # (~3%), hence the looser mass tolerance than the card's 600 s run.
    res = chip_smoke.run_main_path(tmp_path, "cpu", 32, 48, 30.0, 15.0,
                                   mass_tol=0.05, scheme=scheme)
    assert res["steps"] > 0
    assert set(res["launches"]) == set(chip_smoke.kernel_wrappers())
    assert not any(res["launches"].values())
    assert res["volume"] == pytest.approx(res["expected"], rel=0.05)
    assert (tmp_path / "output" / "maxdepth_30.tif").is_file()
    return res


def test_main_path_on_cpu(tmp_path):
    res = _main_path_on_cpu(tmp_path, "godunov")
    assert "Scheme:      godunov" in res["log"]


def test_muscl_main_path_on_cpu(tmp_path):
    """Phase 4b's XML name "musclhancock" runs MUSCL-Hancock, whose
    two-cell ring the forced area leaves out."""
    res = _main_path_on_cpu(tmp_path, "musclhancock")
    assert "Scheme:      muscl-hancock" in res["log"]
    assert res["expected"] == pytest.approx(
        chip_smoke._forced_volume(32, 48, 2, 30.0))


def test_api_path_on_cpu(tmp_path):
    """Phase 4c's recompute-variant run through load_config ->
    Simulation.run, on the CPU (plain versions, so no launches)."""
    res = chip_smoke.run_api_path(tmp_path, "cpu", 32, 48, 30.0,
                                  "recompute", mass_tol=0.05)
    assert res["steps"] > 0 and not any(res["launches"].values())
