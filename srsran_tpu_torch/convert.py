"""Turn reference configuration objects into the port's counterparts.

`from_reference(obj)` reads the dataclass fields of a `srsran_tpu` `Cell`,
`DlGrant`, `DlGrant2`, `UlGrant`, `ChestDlConfig`, `OfdmConfig`, `TbCoding`,
`DlSched`, `Mib`, `PucchConfig`, `UciCfg`, `Agc`, `PrachConfig`, `FadingConfig`,
`RlfConfig`, `DelayConfig`, `HstConfig`, `ChannelConfig`, `TddConfig`, the app
configuration
`AppConfig` (with its `RfConfig`, `PhyConfig`, `ExpertPhyConfig`, `LogConfig`
and `PcapConfig`) or the operator configuration `EnbConfig`, and builds the
port's class of the same name (a nested configuration too; dicts and lists
are copied), so that both packages decode one configuration.  A
`DlSched`'s grants are converted too, and its DCI bits become numpy
arrays.
It goes by the class name and the fields (duck typing), so this package
needs no import of the reference (which would import jax).

State that crosses between the packages is the HARQ softbuffer of the
dynamic-grant and the windowed decodes, and the adaptive Wiener estimator's
state: `softbuffer_from_reference` and `wiener_state_from_reference` take
the reference's arrays (as numpy) onto a device of the port.
"""

from __future__ import annotations

import copy
import dataclasses
import enum

import numpy as np
import torch

from .phy.agc import Agc
from .phy.channel.channel import ChannelConfig, DelayConfig, HstConfig
from .phy.channel.fading import FadingConfig, RlfConfig
from .phy.chest.chest_dl import ChestDlConfig
from .phy.common import CP, Cell
from .phy.enb.enb_dl import DlSched
from .phy.modem import Mod
from .phy.ofdm import OfdmConfig
from .phy.phch.pbch import Mib
from .phy.phch.pdsch import DlGrant, DlGrant2
from .phy.phch.prach import PrachConfig
from .phy.phch.pucch import PucchConfig
from .phy.phch.pusch import UciCfg, UlGrant
from .phy.phch.sch import TbCoding
from .phy.tdd import TddConfig
from .runtime.config import AppConfig, ExpertPhyConfig, LogConfig, PcapConfig, PhyConfig, RfConfig
from .runtime.enb_cfg import EnbConfig

_CLASSES = {c.__name__: c for c in (
    Cell, DlGrant, DlGrant2, UlGrant, ChestDlConfig, OfdmConfig, TbCoding, Mib, PucchConfig,
    UciCfg, Agc, PrachConfig, FadingConfig, RlfConfig, DelayConfig, HstConfig, ChannelConfig,
    AppConfig, RfConfig, PhyConfig, ExpertPhyConfig, LogConfig, PcapConfig, EnbConfig, TddConfig)}
_ENUMS = {e.__name__: e for e in (CP, Mod)}


def _value(v):
    if isinstance(v, enum.Enum):
        return _ENUMS[type(v).__name__](v.value)
    if dataclasses.is_dataclass(v) and type(v).__name__ in _CLASSES:
        return from_reference(v)
    if isinstance(v, (dict, list)):
        return copy.deepcopy(v)
    return v


def from_reference(obj):
    """The port's counterpart of a reference config dataclass."""
    if type(obj).__name__ == "DlSched" and dataclasses.is_dataclass(obj):
        return DlSched(
            cfi=obj.cfi,
            dcis=[(np.array(bits, np.uint8), rnti, agg, cce) for bits, rnti, agg, cce in obj.dcis],
            grants=[(from_reference(g), tb) for g, tb in obj.grants],
            phich=list(obj.phich))
    cls = _CLASSES.get(type(obj).__name__)
    if cls is None or not dataclasses.is_dataclass(obj):
        raise TypeError(f"no counterpart for {type(obj).__name__}")
    return cls(**{f.name: _value(getattr(obj, f.name)) for f in dataclasses.fields(cls)})


def softbuffer_from_reference(softbuffer, device) -> torch.Tensor:
    """A HARQ softbuffer returned by the reference — (b_bucket, 3, k_bucket+4)
    from `DynamicUeDl.decode` or `DynamicEnbUl.decode`, the dense (n_slots, 3,
    K_MAX+4) of a window, or a (MAX_CB, 3, K_MAX+4) block of
    `extract_softbuffer` — as a float32 tensor on `device` that the port's
    counterpart takes."""
    return torch.from_numpy(np.array(softbuffer, dtype=np.float32)).to(device)


def wiener_state_from_reference(state: dict, device) -> dict:
    """The reference's adaptive Wiener state — `wiener_init`'s and
    `chest_dl_adaptive`'s {"r3": (nlags,) complex64, "count": () float32}
    pytree, its leaves as numpy — as the port's state of tensors on `device`."""
    return {"r3": torch.from_numpy(np.array(state["r3"], dtype=np.complex64)).to(device),
            "count": torch.from_numpy(np.array(state["count"], dtype=np.float32)).to(device)}
