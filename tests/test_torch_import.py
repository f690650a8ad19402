"""srsran_tpu_torch imports neither jax nor the JAX reference package."""

import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def test_import_leaves_jax_out():
    code = (
        "import sys, srsran_tpu_torch.pipeline, srsran_tpu_torch.convert\n"
        "import srsran_tpu_torch.pipeline_dynamic, srsran_tpu_torch.phy.phch.ra, chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'srsran_tpu.'))"
        " or m == 'srsran_tpu']\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


def test_sources_never_import_jax():
    pattern = re.compile(r"^\s*(import|from) (jax|srsran_tpu)\b", re.M)
    files = sorted((ROOT / "srsran_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    for path in files:
        assert not pattern.search(path.read_text()), path
