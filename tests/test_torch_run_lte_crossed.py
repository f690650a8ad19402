"""One crossed three-process `run_lte` on the CPU: the port's UE process
(`python -m srsran_tpu_torch.apps.run_lte_3proc --role ue --device cpu`)
attaching to the reference's EPC and eNB processes (`apps/run_lte_3proc.py`,
JAX on the CPU) over the sockets — S1AP and GTP-U between the reference's
processes, the PHY's complex64 subframes in lockstep between the reference's
eNB and the port's UE — 12 s from the first exchange.

It is the kernel-ping case of the reference's `tests/test_run_lte_3proc.py`
with its asserts (the UE registered, `ping_rc == 0`): the port's UE raises
its TUN in a netns and a real ICMP echo crosses all three processes.  The
synthetic-traffic case cannot be held to `ip_rx >= 6` across the packages:
the reference's EPC drops every DL packet it makes before the eNB's first
UL GTP-U packet (ROADMAP Queue 3), one every 10 ms, so the count follows
the wall time of a TTI (3, 5, 5 and 6 of 12 with the port's UE, 7 and 7
with the reference's own, on an idle 8-core host).  With the kernel ping
the DL follows the UL.  All three processes run inside a network namespace
of their own and the UE's TUN in a second one, so that neither meets the
reference tests' TUNs.
"""

import sys
from pathlib import Path

import torch

import chip_smoke
from test_torch_io import del_netns, tun_namespaces

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
REF_APP = [sys.executable, "-u", str(ROOT / "apps" / "run_lte_3proc.py")]


def test_the_ports_ue_attaches_to_the_reference_epc_and_enb():
    """The port's UE process (`--device cpu`) against the reference's EPC and
    eNB processes: one wire format across the packages."""
    epc_ns, ue_ns = tun_namespaces("px_epc", "px_ue")
    env = chip_smoke.child_env(OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    try:
        out = chip_smoke.run_lte_3proc(
            prb=15, duration=12.0, cmds={"epc": REF_APP, "enb": REF_APP,
                                         "ue": chip_smoke.port_cmd("run_lte_3proc")},
            role_args={"ue": ["--device", "cpu"]}, env=env,
            prefix=["ip", "netns", "exec", epc_ns], extra=["--tun", "--netns", ue_ns])
    finally:
        del_netns(epc_ns, ue_ns)
    assert out["ue"]["registered"], out
    assert out["ue"]["ping_rc"] == 0, out["ue"]
    assert out["epc"]["attached"] == [chip_smoke.RUN_LTE_IMSI], out
    assert out["ue"]["device"] == "cpu" and "device" not in out["enb"], out
