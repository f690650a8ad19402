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
        "import srsran_tpu_torch.phy.mimo, srsran_tpu_torch.phy.dft_precoding\n"
        "import srsran_tpu_torch.phy.chest.chest_ul, srsran_tpu_torch.phy.chest.refsignal_ul\n"
        "import srsran_tpu_torch.phy.phch.pusch, srsran_tpu_torch.phy.ue.ue_ul\n"
        "import srsran_tpu_torch.pipeline_window, srsran_tpu_torch.phy.sync.pss\n"
        "import srsran_tpu_torch.phy.sync.sss, srsran_tpu_torch.pipeline_ctrl\n"
        "import srsran_tpu_torch.phy.fec.conv, srsran_tpu_torch.phy.enb.enb_dl\n"
        "import srsran_tpu_torch.phy.phch.pdcch, srsran_tpu_torch.phy.phch.pbch\n"
        "import srsran_tpu_torch.phy.phch.pcfich, srsran_tpu_torch.phy.phch.phich\n"
        "import srsran_tpu_torch.phy.phch.pucch, srsran_tpu_torch.phy.phch.uci\n"
        "import srsran_tpu_torch.phy.phch.dci, srsran_tpu_torch.phy.phch.regs\n"
        "import srsran_tpu_torch.phy.sync.cfo, srsran_tpu_torch.phy.agc\n"
        "import srsran_tpu_torch.phy.ue.ue_sync, srsran_tpu_torch.phy.ue.ue_dl\n"
        "import srsran_tpu_torch.phy.ue.intra_measure, srsran_tpu_torch.stack.mac_pdu\n"
        "import srsran_tpu_torch.runtime.pcap, srsran_tpu_torch.apps.enb, srsran_tpu_torch.apps.ue\n"
        "import srsran_tpu_torch.phy.enb.enb_ul, srsran_tpu_torch.phy.phch.prach\n"
        "import srsran_tpu_torch.phy.chest.srs, srsran_tpu_torch.phy.channel.channel\n"
        "import srsran_tpu_torch.phy.sync.refsignal_dl_sync\n"
        "import srsran_tpu_torch.apps.full_stack, srsran_tpu_torch.apps.windowed_plane\n"
        "import srsran_tpu_torch.epc, srsran_tpu_torch.stack.asn1.s1ap, srsran_tpu_torch.stack.gtpc\n"
        "import srsran_tpu_torch.stack.sched_grid, srsran_tpu_torch.runtime.config\n"
        "import importlib.util as u\n"
        "spec = u.spec_from_file_location('prof', 'tools/profile_torch_dynamic.py')\n"
        "spec.loader.exec_module(u.module_from_spec(spec))\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'srsran_tpu.'))"
        " or m == 'srsran_tpu']\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


def test_every_module_of_the_port_imports_without_jax():
    """Each module file of the package, imported by name in one process."""
    mods = sorted(
        str(p.relative_to(ROOT).with_suffix("")).replace("/", ".").removesuffix(".__init__")
        for p in (ROOT / "srsran_tpu_torch").rglob("*.py"))
    assert "srsran_tpu_torch.phy.ue.ue_ul" in mods and "srsran_tpu_torch.phy.mimo" in mods
    assert "srsran_tpu_torch.pipeline_window" in mods
    assert "srsran_tpu_torch.phy.sync.pss" in mods and "srsran_tpu_torch.phy.sync.sss" in mods
    for m in ("pipeline_ctrl", "phy.fec.conv", "phy.enb.enb_dl", "phy.phch.regs", "phy.phch.dci",
              "phy.phch.pcfich", "phy.phch.phich", "phy.phch.pdcch", "phy.phch.pbch",
              "phy.phch.uci_data", "phy.phch.uci", "phy.phch.pucch", "phy.sync.cfo", "phy.agc",
              "phy.ue.ue_sync", "phy.ue.ue_dl", "phy.ue.intra_measure", "stack.mac_pdu",
              "runtime.pcap", "apps.enb", "apps.ue", "phy.enb.enb_ul", "phy.phch.prach",
              "phy.phch.prach_data", "phy.chest.srs", "phy.channel.fading", "phy.channel.channel",
              "phy.sync.refsignal_dl_sync", "stack.security", "stack.asn1", "stack.asn1.per",
              "stack.asn1.rrc", "stack.asn1.s1ap", "stack.rrc", "stack.nas", "stack.nas_ue",
              "stack.pdcp", "stack.rlc", "stack.mac", "stack.gtpu", "stack.gtpc",
              "stack.sched_grid", "epc", "epc.hss", "epc.mme", "epc.s1ap", "epc.spgw",
              "epc.mbms_gw", "phy.tdd", "runtime.config", "apps.full_stack",
              "apps.windowed_plane"):
        assert f"srsran_tpu_torch.{m}" in mods, m
    code = (
        "import sys, importlib\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'srsran_tpu')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


def test_sources_never_import_jax():
    pattern = re.compile(r"^\s*(import|from) (jax|srsran_tpu)\b", re.M)
    files = sorted((ROOT / "srsran_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "tools" / "profile_torch_dynamic.py"]
    assert len(files) > 30
    for path in files:
        assert not pattern.search(path.read_text()), path
