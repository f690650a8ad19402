"""The port's run scripts (`python -m srsran_tpu_torch.apps.{enb_app,
ue_app,run_lte_demo,run_lte_3proc}`) as processes on the CPU, with one torch
thread each.

- Each script runs on the card by default: without `--device` on a machine
  with no GPU it exits with "no CUDA device" (no CPU fallback).
- `enb_app` -> `ue_app` over UDP through the native ring at the README's 6
  PRB and cell 42, as `chip_smoke.py` phase 34 (`chip_smoke.udp_apps_run`,
  its gates: at least one SDU, each SDU of the UE's MAC pcap a payload the
  eNB wrote, as many as the UE printed), the UE listening 8 s.
- `run_lte_demo` at its 15 PRB, as phase 33 (`chip_smoke.run_lte_demo`:
  attached, every ping and pong through), and with `--tun`: the kernel
  ping through the stack from the UE's TUN, run inside a network namespace
  of the port's own so that its SGi TUN cannot meet the reference tests'.
"""

import subprocess
import sys

import pytest
import torch

import chip_smoke
from test_torch_io import del_netns, netns_name, tun_namespaces

torch.set_num_threads(1)
CPU = ["--device", "cpu"]


def _env():
    return chip_smoke.child_env(OMP_NUM_THREADS="1")


@pytest.mark.parametrize("argv", [["enb_app", "--ttis", "1"], ["ue_app", "--duration", "0"],
                                  ["run_lte_demo"], ["run_lte_3proc", "--role", "enb"],
                                  ["run_lte_3proc", "--role", "ue"]], ids=lambda a: "-".join(a[:3]))
def test_the_scripts_take_the_card_by_default(argv):
    p = subprocess.run([*chip_smoke.port_cmd(argv[0]), *argv[1:]], capture_output=True, text=True,
                       cwd=chip_smoke.ROOT, env=_env(), timeout=120)
    assert p.returncode != 0
    assert "no CUDA device is available" in p.stderr, p.stderr[-2000:]


def test_enb_app_to_ue_app_over_udp():
    r = chip_smoke.udp_apps_run(role_args=CPU, env=_env(), ue_duration=8.0)
    assert r["sdus"] >= 1 and r["map_launches"] == [0, 0]
    assert r["sdu_ttis"] == sorted(set(r["sdu_ttis"]))  # in order, each once


def test_run_lte_demo():
    r = chip_smoke.run_lte_demo(15, role_args=CPU, env=_env())
    assert r["pings"] == r["pongs"] == 4 and 0 < r["attached_tti"] < 100


def test_run_lte_demo_kernel_ping():
    """`run_lte_demo --tun` inside a namespace of its own: the SGi TUN there,
    the UE's TUN in the demo's netns, a real ICMP echo through the stack."""
    epc_ns, = tun_namespaces("pd_epc")
    try:
        p = subprocess.run(["ip", "netns", "exec", epc_ns, *chip_smoke.port_cmd("run_lte_demo"),
                            "--tun", "--netns", netns_name("pd_ue"), *CPU], capture_output=True,
                           text=True, cwd=chip_smoke.ROOT, env=_env(), timeout=240)
    finally:
        del_netns(epc_ns)
    assert p.returncode == 0, p.stdout[-3000:] + p.stderr[-3000:]
    assert "[kernel ping]" in p.stdout and " 0% packet loss" in p.stdout, p.stdout[-3000:]
