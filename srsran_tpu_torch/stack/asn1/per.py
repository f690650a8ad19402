"""Host copy of `srsran_tpu/stack/asn1/per.py`, held to it by `tests/test_torch_stack.py`.

Unaligned PER (UPER, ITU-T X.691) runtime + declarative schema DSL.

The reference carries ~333 kLoC of generated ASN.1 C++ (SURVEY §2.2,
reference lib/src/asn1/rrc_asn1.cc, runtime lib/src/asn1/asn1_utils.cc).
This framework replaces codegen with a small hand-written UPER engine and
declarative schema objects: a message definition is a tree of `Seq` /
`Choice` / `Int` / `Enum` / ... instances, and encode/decode walk the tree.

Value model (plain Python data, no generated classes):
  SEQUENCE      -> dict           (absent OPTIONAL = missing key)
  CHOICE        -> (alt_name, value)
  ENUMERATED    -> str            (the enumerator name)
  INTEGER       -> int
  BOOLEAN       -> bool
  NULL          -> None
  BIT STRING    -> int            (fixed size)  /  (int, nbits)  (variable)
  OCTET STRING  -> bytes
  SEQUENCE OF   -> list

X.691 rules implemented (unaligned variant throughout):
  - constrained whole number  (§10.5.7: minimal bit-field, any range)
  - normally small non-negative whole number (§10.6)
  - semi-constrained whole number with length determinant (§10.7, §10.9)
  - unconstrained length determinant (§10.9.3.6-7; no fragmentation —
    LTE RRC PDUs are far below 16K)
  - ENUMERATED with extension marker (§13)
  - CHOICE with extension alternatives as open types (§22)
  - SEQUENCE with optional/default bitmap, extension-addition groups as
    open types with the normally-small-length count (§18.7-18.9)
  - BIT STRING / OCTET STRING / SEQUENCE OF with constrained or
    unconstrained sizes (§15-§19)
  - open type = pad to octet + octet length determinant (§10.2)

Unknown extension additions and unknown CHOICE extension alternatives are
skipped by their open-type length on decode (the reference's
`unrecognized_ext_group_test`, lib/test/asn1/rrc_asn1_test.cc:525).
"""

from __future__ import annotations


class Asn1Error(Exception):
    pass


TRACE = False  # set True to print field-by-field decode positions


def _trace(msg):
    if TRACE:
        print(msg)


# ---------------------------------------------------------------- bit I/O


class BitWriter:
    def __init__(self, aligned: bool = False):
        self._bits: list[int] = []
        self.aligned = aligned

    def put(self, value: int, nbits: int) -> None:
        if nbits < 0 or (nbits == 0 and value):
            raise Asn1Error(f"bad bitfield {value}/{nbits}")
        if value < 0 or value >> nbits:
            raise Asn1Error(f"value {value} does not fit in {nbits} bits")
        for i in range(nbits - 1, -1, -1):
            self._bits.append((value >> i) & 1)

    def put_bytes(self, data: bytes) -> None:
        for b in data:
            self.put(b, 8)

    def align(self) -> None:
        while len(self._bits) % 8:
            self._bits.append(0)

    def nbits(self) -> int:
        return len(self._bits)

    def to_bytes(self) -> bytes:
        out = bytearray()
        bits = self._bits
        for i in range(0, len(bits), 8):
            chunk = bits[i : i + 8]
            v = 0
            for b in chunk:
                v = (v << 1) | b
            v <<= 8 - len(chunk)
            out.append(v)
        return bytes(out)


class BitReader:
    def __init__(self, data: bytes, nbits: int | None = None, aligned: bool = False):
        self._data = data
        self._pos = 0
        self._end = len(data) * 8 if nbits is None else nbits
        self.aligned = aligned

    def align(self) -> None:
        pad = (-self._pos) % 8
        if pad:
            self.skip(pad)

    def get(self, nbits: int) -> int:
        if self._pos + nbits > self._end:
            raise Asn1Error(f"read past end ({self._pos}+{nbits}>{self._end})")
        v = 0
        for _ in range(nbits):
            byte = self._data[self._pos >> 3]
            v = (v << 1) | ((byte >> (7 - (self._pos & 7))) & 1)
            self._pos += 1
        return v

    def get_bytes(self, n: int) -> bytes:
        return bytes(self.get(8) for _ in range(n))

    def skip(self, nbits: int) -> None:
        if self._pos + nbits > self._end:
            raise Asn1Error("skip past end")
        self._pos += nbits

    def tell(self) -> int:
        return self._pos

    def remaining(self) -> int:
        return self._end - self._pos


# ------------------------------------------------------- whole-number forms


def _bitlen(n: int) -> int:
    return max(1, n.bit_length())


def put_constrained(w: BitWriter, n: int, lo: int, hi: int) -> None:
    """§10.5.7 constrained whole number.  Unaligned: minimal bit-field.
    Aligned: bit-field for range ≤ 255, 1/2 aligned octets up to 64K,
    length-prefixed minimal octets beyond."""
    if not lo <= n <= hi:
        raise Asn1Error(f"{n} outside [{lo},{hi}]")
    rng = hi - lo
    if rng == 0:
        return
    if not w.aligned:
        w.put(n - lo, _bitlen(rng))
        return
    if rng < 255:
        w.put(n - lo, _bitlen(rng))
    elif rng == 255:
        w.align()
        w.put(n - lo, 8)
    elif rng < 65536:
        w.align()
        w.put(n - lo, 16)
    else:
        v = n - lo
        octets = max(1, (v.bit_length() + 7) // 8)
        max_octets = (rng.bit_length() + 7) // 8
        put_constrained(w, octets, 1, max_octets)  # small range → bit-field
        w.align()
        w.put(v, octets * 8)


def get_constrained(r: BitReader, lo: int, hi: int) -> int:
    rng = hi - lo
    if rng == 0:
        return lo
    if not r.aligned:
        return lo + r.get(_bitlen(rng))
    if rng < 255:
        return lo + r.get(_bitlen(rng))
    if rng == 255:
        r.align()
        return lo + r.get(8)
    if rng < 65536:
        r.align()
        return lo + r.get(16)
    max_octets = (rng.bit_length() + 7) // 8
    octets = get_constrained(r, 1, max_octets)
    r.align()
    return lo + r.get(octets * 8)


def put_length(w: BitWriter, n: int) -> None:
    """§10.9 general (unconstrained) length determinant (octet-aligned in
    the aligned variant)."""
    if w.aligned:
        w.align()
    if n < 128:
        w.put(n, 8)
    elif n < 16384:
        w.put(0b10, 2)
        w.put(n, 14)
    else:
        raise Asn1Error("length >= 16K not supported (no fragmentation)")


def get_length(r: BitReader) -> int:
    if r.aligned:
        r.align()
    if r.get(1) == 0:
        return r.get(7)
    if r.get(1) == 0:
        return r.get(14)
    raise Asn1Error("fragmented length not supported")


def put_normally_small(w: BitWriter, n: int) -> None:
    """§10.6 normally small non-negative whole number."""
    if n < 64:
        w.put(0, 1)
        w.put(n, 6)
    else:
        w.put(1, 1)
        octets = max(1, (n.bit_length() + 7) // 8)
        put_length(w, octets)
        w.put(n, octets * 8)


def get_normally_small(r: BitReader) -> int:
    if r.get(1) == 0:
        return r.get(6)
    octets = get_length(r)
    return r.get(octets * 8)


def put_semiconstrained(w: BitWriter, n: int, lo: int) -> None:
    """§10.7: offset from lb as minimal octets with a length determinant."""
    if n < lo:
        raise Asn1Error(f"{n} < lower bound {lo}")
    v = n - lo
    octets = max(1, (v.bit_length() + 7) // 8)
    put_length(w, octets)
    w.put(v, octets * 8)


def get_semiconstrained(r: BitReader, lo: int) -> int:
    octets = get_length(r)
    return lo + r.get(octets * 8)


def put_unconstrained_int(w: BitWriter, n: int) -> None:
    """§10.8 via §12.2.6: 2's-complement minimal octets + length."""
    octets = max(1, (n.bit_length() + 8) // 8)  # +1 sign bit
    put_length(w, octets)
    w.put(n & ((1 << (octets * 8)) - 1), octets * 8)


def get_unconstrained_int(r: BitReader) -> int:
    octets = get_length(r)
    v = r.get(octets * 8)
    if v >> (octets * 8 - 1):
        v -= 1 << (octets * 8)
    return v


def put_constrained_length(w: BitWriter, n: int, lo: int, hi: int | None) -> None:
    """Length determinant for SIZE(lo..hi) per §10.9.3.3."""
    if hi is None:
        put_length(w, n)
    elif hi == lo:
        if n != lo:
            raise Asn1Error(f"fixed size {lo} != {n}")
    elif hi < 65536:
        put_constrained(w, n, lo, hi)
    else:
        put_length(w, n)


def get_constrained_length(r: BitReader, lo: int, hi: int | None) -> int:
    if hi is None:
        return get_length(r)
    if hi == lo:
        return lo
    if hi < 65536:
        return get_constrained(r, lo, hi)
    return get_length(r)


# -------------------------------------------------------------- open types


def put_open_type(w: BitWriter, typ: "Asn1Type", value) -> None:
    """§10.2: contents padded to octets, preceded by an octet count."""
    inner = BitWriter(aligned=w.aligned)
    typ.encode(inner, value)
    if inner.nbits() == 0:
        inner.put(0, 8)  # an empty encoding still occupies one octet
    inner.align()
    data = inner.to_bytes()
    put_length(w, len(data))
    w.put_bytes(data)


def get_open_type(r: BitReader, typ: "Asn1Type"):
    octets = get_length(r)
    data = r.get_bytes(octets)
    sub = BitReader(data, aligned=r.aligned)
    return typ.decode(sub)


def skip_open_type(r: BitReader) -> None:
    octets = get_length(r)
    r.skip(octets * 8)


# ------------------------------------------------------------ type objects


class Asn1Type:
    def encode(self, w: BitWriter, value) -> None:
        raise NotImplementedError

    def decode(self, r: BitReader):
        raise NotImplementedError

    def to_bytes(self, value, aligned: bool = False) -> bytes:
        w = BitWriter(aligned=aligned)
        self.encode(w, value)
        return w.to_bytes()

    def from_bytes(self, data: bytes, aligned: bool = False):
        return self.decode(BitReader(data, aligned=aligned))


class Int(Asn1Type):
    def __init__(self, lo: int | None = None, hi: int | None = None, ext: bool = False):
        self.lo, self.hi, self.ext = lo, hi, ext

    def encode(self, w, value):
        if self.ext:
            in_root = self.lo is not None and self.hi is not None and self.lo <= value <= self.hi
            w.put(0 if in_root else 1, 1)
            if not in_root:
                put_unconstrained_int(w, value)
                return
        if self.lo is None:
            put_unconstrained_int(w, value)
        elif self.hi is None:
            put_semiconstrained(w, value, self.lo)
        else:
            put_constrained(w, value, self.lo, self.hi)

    def decode(self, r):
        if self.ext and r.get(1):
            return get_unconstrained_int(r)
        if self.lo is None:
            return get_unconstrained_int(r)
        if self.hi is None:
            return get_semiconstrained(r, self.lo)
        return get_constrained(r, self.lo, self.hi)


class Bool(Asn1Type):
    def encode(self, w, value):
        w.put(1 if value else 0, 1)

    def decode(self, r):
        return bool(r.get(1))


class Null(Asn1Type):
    def encode(self, w, value):
        pass

    def decode(self, r):
        return None


class Enum(Asn1Type):
    """names: root enumerator names; ext_names: extension enumerators."""

    def __init__(self, names, ext: bool = False, ext_names=()):
        self.names = list(names)
        self.ext = ext or bool(ext_names)
        self.ext_names = list(ext_names)

    def encode(self, w, value):
        if self.ext:
            if value in self.names:
                w.put(0, 1)
            else:
                w.put(1, 1)
                put_normally_small(w, self.ext_names.index(value))
                return
        put_constrained(w, self.names.index(value), 0, len(self.names) - 1)

    def decode(self, r):
        if self.ext and r.get(1):
            idx = get_normally_small(r)
            if idx < len(self.ext_names):
                return self.ext_names[idx]
            return f"_unknown_ext_{idx}"
        return self.names[get_constrained(r, 0, len(self.names) - 1)]


class BitStr(Asn1Type):
    """Fixed size -> plain int value; variable -> (int, nbits)."""

    def __init__(self, lo: int, hi: int | None = None, ext: bool = False):
        self.lo = lo
        self.hi = lo if hi is None else hi
        self.ext = ext

    def encode(self, w, value):
        if self.ext:
            w.put(0, 1)  # sizes outside the root are not used by 36.331
        if self.hi == self.lo:
            if w.aligned and self.lo > 16:
                w.align()
            w.put(value, self.lo)
            return
        v, n = value
        put_constrained_length(w, n, self.lo, self.hi)
        if w.aligned and n > 0:
            w.align()
        w.put(v, n)

    def decode(self, r):
        if self.ext and r.get(1):
            raise Asn1Error("extended BIT STRING size not supported")
        if self.hi == self.lo:
            if r.aligned and self.lo > 16:
                r.align()
            return r.get(self.lo)
        n = get_constrained_length(r, self.lo, self.hi)
        if r.aligned and n > 0:
            r.align()
        return (r.get(n), n)


class OctStr(Asn1Type):
    def __init__(self, lo: int = 0, hi: int | None = None, contained: "Asn1Type | None" = None):
        self.lo, self.hi = lo, hi
        self.contained = contained  # CONTAINING type: value is the inner value

    def encode(self, w, value):
        if self.contained is not None:
            value = self.contained.to_bytes(value, aligned=w.aligned)
        fixed_small = self.hi == self.lo and self.hi is not None and self.hi <= 2
        put_constrained_length(w, len(value), self.lo, self.hi)
        if w.aligned and len(value) and not fixed_small:
            w.align()
        w.put_bytes(value)

    def decode(self, r):
        fixed_small = self.hi == self.lo and self.hi is not None and self.hi <= 2
        n = get_constrained_length(r, self.lo, self.hi)
        if r.aligned and n and not fixed_small:
            r.align()
        data = r.get_bytes(n)
        if self.contained is not None:
            return self.contained.from_bytes(data, aligned=r.aligned)
        return data


class SeqOf(Asn1Type):
    def __init__(self, elem: Asn1Type, lo: int = 0, hi: int | None = None):
        self.elem, self.lo, self.hi = elem, lo, hi

    def encode(self, w, value):
        put_constrained_length(w, len(value), self.lo, self.hi)
        for v in value:
            self.elem.encode(w, v)

    def decode(self, r):
        n = get_constrained_length(r, self.lo, self.hi)
        return [self.elem.decode(r) for _ in range(n)]


# Sequence field descriptors
def M(name: str, typ: Asn1Type):
    return (name, typ, "M", None)


def O(name: str, typ: Asn1Type):
    return (name, typ, "O", None)


def D(name: str, typ: Asn1Type, default):
    return (name, typ, "D", default)


class Seq(Asn1Type):
    """SEQUENCE.  `fields` are root fields; `ext` adds the extension marker;
    `ext_additions` is a list of extension additions in definition order —
    each either a single field tuple (M/O/D) or a version-bracket group
    given as a nested Seq-like list of field tuples (encoded as one open
    type containing a synthetic sequence, §18.9).

    Values are dicts.  A version-bracket group's fields live flat in the
    same dict; the group is emitted when any of its fields is present.
    """

    def __init__(self, fields, ext: bool = False, ext_additions=()):
        self.fields = list(fields)
        self.ext = ext or bool(ext_additions)
        # A bare field tuple is a lone addition (open type = the value);
        # a list is a version-bracket group `[[ ... ]]` (open type = presence
        # bits + values), even when it contains a single field — X.691 §18.9
        # encodes the two differently.
        norm = []
        for add in ext_additions:
            if isinstance(add, tuple) and len(add) == 4 and isinstance(add[0], str):
                norm.append(("single", [add]))
            else:
                norm.append(("group", list(add)))
        self.ext_additions = norm

    def _group_present(self, add, value: dict) -> bool:
        _kind, group = add
        return any(name in value for (name, _t, _p, _d) in group)

    def encode(self, w, value: dict):
        if self.ext:
            # raw additions ("_extN" keys) preserve unknown extensions seen
            # on decode, so decode→encode stays bit-exact even for schema
            # versions newer than ours
            raw_idx = [
                int(k[4:]) for k in value
                if isinstance(k, str) and k.startswith("_ext") and k[4:].isdigit()
            ]
            n_slots = max(
                [len(self.ext_additions)] + [i + 1 for i in raw_idx]
            )
            present = [
                (i < len(self.ext_additions) and self._group_present(self.ext_additions[i], value))
                or (f"_ext{i}" in value)
                for i in range(n_slots)
            ]
            has_ext = any(present)
            w.put(1 if has_ext else 0, 1)
        for name, typ, pres, dflt in self.fields:
            if pres == "O":
                w.put(1 if name in value else 0, 1)
            elif pres == "D":
                w.put(0 if value.get(name, dflt) == dflt else 1, 1)
        for name, typ, pres, dflt in self.fields:
            if pres == "M":
                if name not in value:
                    raise Asn1Error(f"missing mandatory field {name}")
                typ.encode(w, value[name])
            elif pres == "O":
                if name in value:
                    typ.encode(w, value[name])
            else:  # D
                if value.get(name, dflt) != dflt:
                    typ.encode(w, value[name])
        if self.ext and has_ext:
            # §18.8: normally-small length = number of additions defined by
            # the encoder's schema version.  "_ext_count" preserves the
            # count observed on decode so repack stays bit-exact even when
            # the sender's schema is newer/older than ours.
            last = max(i + 1 for i, p in enumerate(present) if p)
            count = max(value.get("_ext_count", n_slots), last)
            present += [False] * (count - len(present))
            put_normally_small(w, count - 1)
            for i in range(count):
                w.put(1 if present[i] else 0, 1)
            for i in range(count):
                if not present[i]:
                    continue
                if f"_ext{i}" in value:
                    raw = value[f"_ext{i}"]
                    put_length(w, len(raw))
                    w.put_bytes(raw)
                    continue
                kind, group = self.ext_additions[i]
                if kind == "single":
                    # a lone addition is an open type of its own type
                    # (§18.9); the bitmap already carries its presence
                    put_open_type(w, group[0][1], value[group[0][0]])
                else:
                    put_open_type(w, _GroupSeq(group), value)

    def decode(self, r):
        has_ext = bool(r.get(1)) if self.ext else False
        presence = {}
        for name, typ, pres, dflt in self.fields:
            if pres in ("O", "D"):
                presence[name] = bool(r.get(1))
        out = {}
        for name, typ, pres, dflt in self.fields:
            if pres == "M" or presence.get(name):
                _trace(f"@{r.tell()} {name}")
                out[name] = typ.decode(r)
                _trace(f"@{r.tell()} {name} = {out[name]!r}" if not isinstance(typ, (Seq, Choice)) else f"@{r.tell()} {name} done")
            elif pres == "D":
                out[name] = dflt
        if has_ext:
            count = get_normally_small(r) + 1
            if count != len(self.ext_additions):
                out["_ext_count"] = count
            flags = [bool(r.get(1)) for _ in range(count)]
            for i, flag in enumerate(flags):
                if not flag:
                    continue
                if i >= len(self.ext_additions):
                    # unknown future addition: keep the raw open type so a
                    # re-encode reproduces the original bits
                    octets = get_length(r)
                    out[f"_ext{i}"] = r.get_bytes(octets)
                    continue
                kind, group = self.ext_additions[i]
                if kind == "single":
                    out[group[0][0]] = get_open_type(r, group[0][1])
                else:
                    out.update(get_open_type(r, _GroupSeq(group)))
        return out


class _GroupSeq(Asn1Type):
    """Version-bracket extension group: encoded like a SEQUENCE of its
    fields (all additions within a group keep their own optionality)."""

    def __init__(self, fields):
        self.fields = list(fields)

    def encode(self, w, value: dict):
        for name, typ, pres, dflt in self.fields:
            if pres in ("O", "D"):
                w.put(1 if name in value else 0, 1)
        for name, typ, pres, dflt in self.fields:
            if pres == "M" or name in value:
                typ.encode(w, value[name])

    def decode(self, r):
        presence = {}
        for name, typ, pres, dflt in self.fields:
            if pres in ("O", "D"):
                presence[name] = bool(r.get(1))
        out = {}
        for name, typ, pres, dflt in self.fields:
            if pres == "M" or presence.get(name):
                out[name] = typ.decode(r)
        return out


class Choice(Asn1Type):
    """alts / ext_alts: list of (name, type).  Value = (name, value)."""

    def __init__(self, alts, ext: bool = False, ext_alts=()):
        self.alts = list(alts)
        self.ext = ext or bool(ext_alts)
        self.ext_alts = list(ext_alts)

    def _names(self):
        return [n for n, _ in self.alts]

    def encode(self, w, value):
        name, inner = value
        names = self._names()
        if self.ext:
            if name in names:
                w.put(0, 1)
            elif name.startswith("_unknown_ext_"):
                w.put(1, 1)
                put_normally_small(w, int(name[13:]))
                put_length(w, len(inner))
                w.put_bytes(inner)
                return
            else:
                w.put(1, 1)
                idx = [n for n, _ in self.ext_alts].index(name)
                put_normally_small(w, idx)
                put_open_type(w, self.ext_alts[idx][1], inner)
                return
        idx = names.index(name)
        if len(self.alts) > 1:
            put_constrained(w, idx, 0, len(self.alts) - 1)
        self.alts[idx][1].encode(w, inner)

    def decode(self, r):
        if self.ext and r.get(1):
            idx = get_normally_small(r)
            if idx < len(self.ext_alts):
                name, typ = self.ext_alts[idx]
                return (name, get_open_type(r, typ))
            octets = get_length(r)
            return (f"_unknown_ext_{idx}", r.get_bytes(octets))
        idx = get_constrained(r, 0, len(self.alts) - 1) if len(self.alts) > 1 else 0
        name, typ = self.alts[idx]
        return (name, typ.decode(r))


class CharStr(Asn1Type):
    """Known-multiplier character string with 8-bit characters in the
    aligned variant (PrintableString/IA5String as used by S1AP §30).
    Value = str."""

    def __init__(self, lo: int = 0, hi: int | None = None, ext: bool = False):
        self.lo, self.hi, self.ext = lo, hi, ext

    def encode(self, w, value: str):
        data = value.encode("ascii")
        if self.ext:
            w.put(0, 1)
        put_constrained_length(w, len(data), self.lo, self.hi)
        if w.aligned and (len(data) * 8 > 16 or self.hi != self.lo):
            w.align()
        w.put_bytes(data)

    def decode(self, r):
        if self.ext and r.get(1):
            raise Asn1Error("extended string size not supported")
        n = get_constrained_length(r, self.lo, self.hi)
        if r.aligned and (n * 8 > 16 or self.hi != self.lo):
            r.align()
        return r.get_bytes(n).decode("ascii")


class Todo(Asn1Type):
    """Placeholder for a schema branch not yet defined (e.g. inter-RAT
    structures).  Keeps CHOICE arities spec-correct — selecting the
    alternative raises a clear error instead of silently mis-decoding."""

    def __init__(self, what: str):
        self.what = what

    def encode(self, w, value):
        raise Asn1Error(f"schema not implemented: {self.what}")

    def decode(self, r):
        raise Asn1Error(f"schema not implemented: {self.what}")


def c1_spares(alts, n_spares: int, ext: bool = False):
    """The 36.331 `c1` pattern: CHOICE of real alternatives + spareN NULLs."""
    full = list(alts) + [(f"spare{n_spares - i}", Null()) for i in range(n_spares)]
    return Choice(full, ext=ext)
