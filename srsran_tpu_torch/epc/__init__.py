"""Host copy of `srsran_tpu/epc/__init__.py`, held to it by `tests/test_torch_stack.py`.

srsEPC-equivalent core network: MME (S1AP + NAS FSM), HSS (Milenage
vectors, user_db.csv), SPGW (GTP-U anchor + IP pool), MBMS-GW (M1-U eMBMS tunnel). See
srsepc/src in the reference."""

from .hss import AuthVector, Hss, Subscriber
from .mme import Mme, UeCtx
from .mbms_gw import M1uReceiver, MbmsGw
from .spgw import Spgw
from . import s1ap

__all__ = ["AuthVector", "Hss", "Subscriber", "Mme", "UeCtx", "Spgw", "MbmsGw", "M1uReceiver", "s1ap"]
