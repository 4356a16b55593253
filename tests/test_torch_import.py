"""The port stands alone: importing every module of hipims_tpu_torch loads
neither JAX nor the JAX package, and no source names them."""

import re
import subprocess
import sys
from pathlib import Path

import hipims_tpu_torch
from hipims_tpu_torch import constants as C

PKG = Path(hipims_tpu_torch.__file__).parent
ROOT = PKG.parent

IMPORT_ALL = """
import importlib, pkgutil, sys
import hipims_tpu_torch as pkg
names = [m.name for m in
         pkgutil.walk_packages(pkg.__path__, "hipims_tpu_torch.")
         if not m.name.endswith("__main__")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "hipims_tpu"
             or m.startswith("hipims_tpu."))
print(len(names), bad)
assert not bad, bad
"""


def test_importing_every_module_loads_no_jax():
    res = subprocess.run([sys.executable, "-c", IMPORT_ALL], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    n_modules = int(res.stdout.split()[0])
    assert n_modules >= 20


def test_no_source_imports_jax_or_the_jax_package():
    pattern = re.compile(r"^\s*(import|from)\s+(jax\b|hipims_tpu(\.|\s|$))",
                         re.M)
    offenders = [str(p.relative_to(ROOT))
                 for p in [*PKG.rglob("*.py"), ROOT / "chip_smoke.py"]
                 if pattern.search(p.read_text())]
    assert offenders == []


def test_cuda_constants_match_python():
    """Every constant the CUDA headers repeat equals its Python value (in
    constants.py, or in ops/muscl.py for the MUSCL thresholds)."""
    from hipims_tpu_torch.ops import muscl

    seen = set()
    for header in sorted((PKG / "csrc").glob("*.cuh")):
        for name, value in re.findall(
                r"constexpr double (\w+) = ([-0-9.e]+);",
                header.read_text()):
            python = getattr(C, name, getattr(muscl, name, None))
            assert python is not None, (header.name, name)
            assert float(value) == python, (header.name, name)
            seen.add(name)
    assert {"GRAVITY", "NODATA", "STOP_FLOW_EPS", "STOP_FLOW_REL",
            "MINBEE_BETA", "FIRST_ORDER_DRY_DEPTH",
            "SENTINEL_ZMAX"} <= seen
