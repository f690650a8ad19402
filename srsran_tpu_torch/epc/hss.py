"""Host copy of `srsran_tpu/epc/hss.py`, held to it by `tests/test_torch_stack.py`.

HSS: subscriber database + Milenage authentication vectors
(re-design of `srsepc/src/hss/hss.cc`).

Reads the reference's `user_db.csv` format:
  name,auth_algo,imsi,key,op_type,op/opc,amf,sqn,qci,ip_alloc
"""

from __future__ import annotations

import dataclasses
import os

from ..stack import security as sec


@dataclasses.dataclass
class Subscriber:
    name: str
    imsi: str
    key: bytes
    opc: bytes
    amf: bytes
    sqn: int
    auth_algo: str = "mil"  # mil | xor
    qci: int = 9
    static_ip: str | None = None


@dataclasses.dataclass
class AuthVector:
    rand: bytes
    xres: bytes
    autn: bytes
    ck: bytes
    ik: bytes
    k_asme: bytes


class Hss:
    def __init__(self):
        self.db: dict[str, Subscriber] = {}
        self._rand_state = int.from_bytes(os.urandom(8), "big")

    def add_subscriber(self, sub: Subscriber):
        self.db[sub.imsi] = sub

    def load_csv(self, path: str):
        """Parse the reference's user_db.csv format (hss.cc user db)."""
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                p = line.split(",")
                name, algo, imsi, key_hex, op_type, op_hex, amf_hex, sqn_hex = p[:8]
                key = bytes.fromhex(key_hex)
                op = bytes.fromhex(op_hex)
                opc = op if op_type == "opc" else sec.compute_opc(key, op)
                self.add_subscriber(
                    Subscriber(
                        name=name,
                        imsi=imsi,
                        key=key,
                        opc=opc,
                        amf=bytes.fromhex(amf_hex),
                        sqn=int(sqn_hex, 16),
                        auth_algo=algo,
                        qci=int(p[8]) if len(p) > 8 else 9,
                        static_ip=p[9] if len(p) > 9 and p[9] != "dynamic" else None,
                    )
                )

    def _next_rand(self) -> bytes:
        self._rand_state = (self._rand_state * 6364136223846793005 + 1442695040888963407) % (1 << 128)
        return self._rand_state.to_bytes(16, "big")

    def get_auth_vector(self, imsi: str, plmn: bytes = b"\x00\xf1\x10") -> AuthVector | None:
        """Generate a fresh EPS authentication vector (TS 33.401 §6.1)."""
        sub = self.db.get(imsi)
        if sub is None:
            return None
        sub.sqn += 1
        sqn = sub.sqn.to_bytes(6, "big")
        rand = self._next_rand()
        mac_a = sec.milenage_f1(sub.key, sub.opc, rand, sqn, sub.amf)
        res, ck, ik, ak, _ = sec.milenage_f2345(sub.key, sub.opc, rand)
        sqn_xor_ak = bytes(a ^ b for a, b in zip(sqn, ak))
        autn = sqn_xor_ak + sub.amf + mac_a
        k_asme = sec.generate_k_asme(ck, ik, plmn, sqn_xor_ak)
        return AuthVector(rand, res, autn, ck, ik, k_asme)
