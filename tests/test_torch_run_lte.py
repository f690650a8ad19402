"""The port's three-process `run_lte` (`srsran_tpu_torch/apps/run_lte_3proc.py`)
on the CPU: the reference's `tests/test_run_lte_3proc.py` on the port.

The roles run as `python -m srsran_tpu_torch.apps.run_lte_3proc` child
processes with `--device cpu` and one torch thread each, started by
`chip_smoke.run_lte_3proc` (which `chip_smoke.py` phase 32 runs), and
are held to the reference test's asserts (`chip_smoke.check_run_lte`): the
UE registered, the EPC attached the one IMSI, at least 6 DL and 3 UL IP
packets across all three process boundaries.

- The port's three roles, 12 s from the first exchange.  The reference
  test's `ttis > 500` in 45 s reads a CPU JAX run; here the floor is 10
  TTIs a second of the run (120), a third of the port's unloaded CPU rate
  at 15 PRB (~30 ms a lockstep TTI), so that a loaded machine passes.  All
  12 DL packets arrive: the port's EPC keeps DL GTP-U queued until it
  knows the eNB's address, where the reference's drops a packet per loop
  pass before that.
- The kernel ping (`--tun`): the UE's TUN in a netns and the EPC's SGi TUN,
  a real ICMP echo through all three processes.  All three run inside a
  network namespace of the port's own and the UE's TUN moves to a second
  one, so that neither meets the reference tests' TUNs (their SGi holds
  172.16.0.254/24 in the root namespace).

The crossed run (the port's UE against the reference's EPC and eNB) is in
`tests/test_torch_run_lte_crossed.py`.
"""

import torch

import chip_smoke
from test_torch_io import del_netns, tun_namespaces

torch.set_num_threads(1)
PRB = 15
DURATION = 12.0
TTIS_PER_S = 10  # the floor of TTIs a second of the run on the CPU (docstring)
CPU_ROLES = {"enb": ["--device", "cpu"], "ue": ["--device", "cpu"]}


def _env():
    return chip_smoke.child_env(OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu",
                                SRSRAN_TPU_NO_COMPCACHE="1")


def test_three_process_attach_and_ip():
    out = chip_smoke.run_lte_3proc(prb=PRB, duration=DURATION, role_args=CPU_ROLES, env=_env())
    chip_smoke.check_run_lte(out, min_ttis=int(TTIS_PER_S * DURATION))
    ue, enb, epc = out["ue"], out["enb"], out["epc"]
    assert ue["ip_rx"] == epc["dl_sent"] == 12, out  # nothing dropped before the eNB's address
    assert ue["ul_sent"] == 6 and epc["sgi_rx"] == 6, out
    assert ue["device"] == enb["device"] == "cpu", out
    assert ue["map_launches"] == enb["map_launches"] == {"static": 0, "dyn": 0}  # the CPU runs plain
    assert ue["ttis"] == enb["ttis"] and 0 < ue["attached_tti"] < 100
    assert ue["tti_ms"] > 0 and enb["busy_ms"] > 0 and ue["busy_ms"] > 0


def test_three_process_kernel_ping():
    """run_lte.sh in full on the port: UE TUN in a netns, real ICMP through
    all three processes and both socket transports."""
    epc_ns, ue_ns = tun_namespaces("p3_epc", "p3_ue")
    try:
        out = chip_smoke.run_lte_3proc(prb=PRB, duration=DURATION, role_args=CPU_ROLES, env=_env(),
                                       prefix=["ip", "netns", "exec", epc_ns],
                                       extra=["--tun", "--netns", ue_ns])
        assert out["ue"]["registered"], out
        assert out["ue"]["ping_rc"] == 0, out["ue"]
    finally:
        del_netns(epc_ns, ue_ns)

