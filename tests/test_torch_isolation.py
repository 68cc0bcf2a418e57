"""The PyTorch port stands alone: importing it loads neither JAX nor any
module of the JAX package, and no source of the port (nor chip_smoke.py)
imports them.  The import check runs in a fresh interpreter, because this
test process has JAX loaded already (tests/conftest.py)."""

import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "tacotron_tpu_torch"

IMPORT_ALL = r"""
import importlib, pkgutil, sys
import tacotron_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    tacotron_tpu_torch.__path__, "tacotron_tpu_torch.")
    if not m.name.endswith("__main__")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                    "tacotron_tpu"))
print(len(names))
assert not bad, bad
assert {f"tacotron_tpu_torch.studies.{m}" for m in (
    "make_synthetic_corpus", "convergence_study", "mulaw_quality",
    "serving_load", "synth_sweep", "bf16_study", "batch_study")
    } | {"tacotron_tpu_torch.bench"} <= set(names), names
"""

# an import of JAX, flax or optax, or any mention of the JAX package as a
# module (a file path such as tacotron_tpu/ops/... names a source, not an
# import)
FORBIDDEN = [re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|optax)\b",
                        re.M),
             re.compile(r"\btacotron_tpu\b(?!_torch|/)")]


def test_import_loads_no_jax():
    proc = subprocess.run([sys.executable, "-c", IMPORT_ALL], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 55   # every module was imported


def test_sources_name_no_jax():
    files = sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) >= 60
    for path in files:
        text = path.read_text(encoding="utf-8")
        for pattern in FORBIDDEN:
            hit = pattern.search(text)
            assert hit is None, f"{path.relative_to(ROOT)}: {hit.group(0)!r}"
