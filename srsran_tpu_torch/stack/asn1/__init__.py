"""Host copy of `srsran_tpu/stack/asn1/__init__.py`, held to it by `tests/test_torch_stack.py`.

Hand-written ASN.1 UPER codec (runtime + TS 36.331 RRC schemas).

Replaces the reference's generated ASN.1 layer (SURVEY §2.2,
lib/src/asn1/) with a declarative Python DSL: `per` is the X.691
unaligned-PER engine, `rrc` the 36.331 message subset validated against
the reference's golden conformance vectors.
"""

from . import per, rrc

__all__ = ["per", "rrc"]
