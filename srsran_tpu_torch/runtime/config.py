"""Host copy of `srsran_tpu/runtime/config.py`, held to it by `tests/test_torch_stack.py`.

Config system: INI files + CLI overrides.

The reference layers boost::program_options over INI files where every key
is also a flag (`srsue/src/main.cc:35-490`, sections in
`ue.conf.example:30-380`).  Same model here: `load_config` parses an INI
into an `AppConfig`, and `--section.key=value` CLI arguments override.
"""

from __future__ import annotations

import configparser
import dataclasses
from typing import Any


@dataclasses.dataclass
class RfConfig:
    srate_hz: float = 1.92e6
    rx_gain: float = 40.0
    tx_gain: float = 40.0
    freq_offset_hz: float = 0.0
    device: str = "file"  # file | udp | zeros
    device_args: str = ""


@dataclasses.dataclass
class PhyConfig:
    nof_prb: int = 6
    nof_ports: int = 1
    cell_id: int = 1
    cfi: int = 1
    nof_carriers: int = 1
    max_turbo_iterations: int = 5
    rx_antennas: int = 1
    snr_estim_alg: str = "refs"


@dataclasses.dataclass
class ExpertPhyConfig:
    """The reference's [expert] PHY tuning plane (ue.conf.example:318-385,
    srsue/src/main.cc expert.phy options).  Every knob is parseable; the
    wired subset is documented per field — the rest map onto the
    corresponding module configs (ChestDlConfig, sync loops) for callers
    that construct those directly."""

    # CQI reporting (cc_worker.cc set_uci_periodic_cqi inputs)
    cqi_max: int = 15            # clamp on reported wideband CQI
    cqi_fixed: int = -1          # >=0 pins every report (link-adapt tests)
    snr_to_cqi_offset: float = 0.0
    snr_ema_coeff: float = 0.1   # EMA on the measured DL SNR
    # PDSCH decoder
    pdsch_max_its: int = 5       # full iterations (ref counts half-its: 8)
    pdsch_8bit_decoder: bool = False  # windowed-plane int8 vs int16 ingest
    pdsch_csi_enabled: bool = True
    equalizer_mode: str = "mmse"  # mmse | zf
    # UL
    force_ul_amplitude: float = 0.0  # >0 scales the UL peak to this
    # radio-link monitoring defaults (rrc.cc:428 N310/N311 chain; SIB2
    # values override once acquired)
    in_sync_rsrp_dbm_th: float = -130.0
    in_sync_snr_db_th: float = 3.0
    nof_in_sync_events: int = 10
    nof_out_of_sync_events: int = 20
    # sync/chest loops (map onto phy.sync loops / ChestDlConfig)
    sfo_ema: float = 0.1
    sfo_correct_period: int = 10
    sss_algorithm: str = "full"
    estimator_fil_order: int = 4      # → ChestDlConfig.smooth_len
    estimator_fil_auto: bool = False
    estimator_fil_stddev: float = 1.0
    interpolate_subframe_enabled: bool = False
    snr_estim_alg: str = "refs"
    pdsch_meas_evm: bool = False


@dataclasses.dataclass
class LogConfig:
    level: str = "info"
    filename: str = ""
    hex_limit: int = 32


@dataclasses.dataclass
class PcapConfig:
    enable: bool = False
    filename: str = "/tmp/srsran_tpu_mac.pcap"


@dataclasses.dataclass
class AppConfig:
    rf: RfConfig = dataclasses.field(default_factory=RfConfig)
    phy: PhyConfig = dataclasses.field(default_factory=PhyConfig)
    expert: ExpertPhyConfig = dataclasses.field(
        default_factory=ExpertPhyConfig)
    log: LogConfig = dataclasses.field(default_factory=LogConfig)
    pcap: PcapConfig = dataclasses.field(default_factory=PcapConfig)
    rnti: int = 0x46


def _coerce(cur: Any, raw: str) -> Any:
    if isinstance(cur, bool):
        return raw.strip().lower() in ("1", "true", "yes", "on")
    if isinstance(cur, int):
        return int(raw, 0)
    if isinstance(cur, float):
        return float(raw)
    return raw


def load_config(path: str | None = None, overrides: list[str] | None = None) -> AppConfig:
    """Build config from an INI file and/or `section.key=value` overrides."""
    cfg = AppConfig()
    if path:
        ini = configparser.ConfigParser()
        ini.read(path)
        for section in ini.sections():
            target = getattr(cfg, section, None)
            if target is None:
                continue
            for key, raw in ini.items(section):
                if hasattr(target, key):
                    setattr(target, key, _coerce(getattr(target, key), raw))
    for ov in overrides or []:
        key, _, raw = ov.partition("=")
        parts = key.lstrip("-").split(".")
        if len(parts) == 1:
            if hasattr(cfg, parts[0]):
                setattr(cfg, parts[0], _coerce(getattr(cfg, parts[0]), raw))
            continue
        target = getattr(cfg, parts[0], None)
        if target is not None and hasattr(target, parts[1]):
            setattr(target, parts[1], _coerce(getattr(target, parts[1]), raw))
    return cfg
