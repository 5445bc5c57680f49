"""Minimal pure-Python reader for R workspace files (.rda / .RData).

Exists so the framework can load the reference's shipped golden datasets
(reference: data/modsimdata.rda, data/modsimresult.rda, data/GIST.RData)
for golden-trajectory validation without an R installation. Supports the
XDR ("X\\n") serialization of RDS format versions 2 and 3 — the subset of
SEXP types those files actually contain (numeric/integer/logical/string
vectors, lists, pairlists, S4 objects, attributes, ALTREP-wrapped
vectors, reference table) — not the full R serialization spec.

R objects map to: numeric/integer/logical vectors -> numpy arrays (with
a `dim` attribute applied, giving column-major matrices), character
vectors -> list[str], VECSXP -> list (or dict when named), S4SXP ->
RS4(class_name, attributes dict), pairlists -> dict.

A copy of cogaps_tpu/io/rdata.py (numpy and the standard library only).
"""

from __future__ import annotations

import bz2
import gzip
import lzma
import struct
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

# SEXP type codes (R internals)
NILSXP = 0
SYMSXP = 1
LISTSXP = 2
CLOSXP = 3
ENVSXP = 4
LANGSXP = 6
CHARSXP = 9
LGLSXP = 10
INTSXP = 13
REALSXP = 14
CPLXSXP = 15
STRSXP = 16
VECSXP = 19
EXPRSXP = 20
RAWSXP = 24
S4SXP = 25
# pseudo-types used by the serialization format
BASEENV_SXP = 241
EMPTYENV_SXP = 242
GENERICREFSXP = 245
CLASSREFSXP = 246
PERSISTSXP = 247
PACKAGESXP = 248
NAMESPACESXP = 249
BASENAMESPACE_SXP = 250
MISSINGARG_SXP = 251
UNBOUNDVALUE_SXP = 252
GLOBALENV_SXP = 253
NILVALUE_SXP = 254
REFSXP = 255
ALTREP_SXP = 238
ATTRLISTSXP = 239
ATTRLANGSXP = 240


@dataclass
class RS4:
    """An S4 object: class name plus slot dictionary."""

    class_name: str
    slots: Dict[str, Any] = field(default_factory=dict)

    def __getitem__(self, key):
        return self.slots[key]

    def get(self, key, default=None):
        return self.slots.get(key, default)


@dataclass
class RObj:
    """A parsed R object with attributes (dim/dimnames/names/class...)."""

    value: Any
    attributes: Dict[str, Any] = field(default_factory=dict)


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.refs: List[Any] = []

    # ---- primitive reads (XDR = big-endian) ----
    def _int(self) -> int:
        v = struct.unpack_from(">i", self.data, self.pos)[0]
        self.pos += 4
        return v

    def _double(self) -> float:
        v = struct.unpack_from(">d", self.data, self.pos)[0]
        self.pos += 8
        return v

    def _bytes(self, n: int) -> bytes:
        v = self.data[self.pos:self.pos + n]
        self.pos += n
        return v

    def _ints(self, n: int) -> np.ndarray:
        v = np.frombuffer(self.data, dtype=">i4", count=n, offset=self.pos)
        self.pos += 4 * n
        return v.astype(np.int32)

    def _doubles(self, n: int) -> np.ndarray:
        v = np.frombuffer(self.data, dtype=">f8", count=n, offset=self.pos)
        self.pos += 8 * n
        return v.astype(np.float64)

    def _length(self) -> int:
        n = self._int()
        if n == -1:  # long vector: two 32-bit halves
            hi = self._int()
            lo = self._int()
            return (hi << 32) | (lo & 0xFFFFFFFF)
        return n

    # ---- item dispatch ----
    def read_item(self) -> Any:
        flags = self._int()
        typ = flags & 0xFF
        has_attr = bool(flags & 0x200)
        has_tag = bool(flags & 0x400)

        if typ == NILVALUE_SXP or typ == NILSXP:
            return None
        if typ == REFSXP:
            ref_ix = flags >> 8
            if ref_ix == 0:
                ref_ix = self._int()
            return self.refs[ref_ix - 1]
        if typ == SYMSXP:
            sym = self.read_item()  # CHARSXP
            self.refs.append(sym)
            return sym
        if typ == CHARSXP:
            n = self._int()
            if n == -1:
                return None  # NA_character_
            return self._bytes(n).decode("utf-8", errors="replace")
        if typ in (LISTSXP, LANGSXP):
            # pairlist: [attr] [tag] car cdr
            attr = self.read_item() if has_attr else None
            tag = self.read_item() if has_tag else None
            car = self.read_item()
            cdr = self.read_item()
            pairs = [(tag, car)]
            while isinstance(cdr, _Pairlist):
                pairs.extend(cdr.pairs)
                cdr = cdr.tail
            pl = _Pairlist(pairs, cdr)
            del attr
            return pl
        if typ == LGLSXP:
            n = self._length()
            v = self._ints(n)
            arr = np.where(v == -2147483648, np.nan, v.astype(np.float64))
            arr = arr.astype(object) if np.isnan(arr).any() else v.astype(bool)
            return self._with_attrs(arr, has_attr)
        if typ == INTSXP:
            n = self._length()
            v = self._ints(n)
            return self._with_attrs(v, has_attr)
        if typ == REALSXP:
            n = self._length()
            v = self._doubles(n)
            return self._with_attrs(v, has_attr)
        if typ == STRSXP:
            n = self._length()
            v = [self.read_item() for _ in range(n)]
            return self._with_attrs(v, has_attr)
        if typ in (VECSXP, EXPRSXP):
            n = self._length()
            v = [self.read_item() for _ in range(n)]
            return self._with_attrs(v, has_attr)
        if typ == RAWSXP:
            n = self._length()
            return self._with_attrs(np.frombuffer(
                self._bytes(n), dtype=np.uint8), has_attr)
        if typ == CPLXSXP:
            n = self._length()
            v = np.frombuffer(self.data, dtype=">c16", count=n,
                              offset=self.pos).astype(np.complex128)
            self.pos += 16 * n
            return self._with_attrs(v, has_attr)
        if typ == S4SXP:
            attrs = self.read_item() if has_attr else None
            slots = _pairlist_to_dict(attrs)
            cls = slots.pop("class", ["S4"])
            if isinstance(cls, RObj):
                cls = cls.value
            name = cls[0] if isinstance(cls, list) and cls else str(cls)
            return RS4(class_name=name, slots=slots)
        if typ == ALTREP_SXP:
            info = self.read_item()  # pairlist: class symbol etc.
            state = self.read_item()
            attr = self.read_item()
            del attr
            return _decode_altrep(info, state)
        if typ in (GLOBALENV_SXP, BASEENV_SXP, EMPTYENV_SXP,
                   MISSINGARG_SXP, UNBOUNDVALUE_SXP, BASENAMESPACE_SXP):
            return None
        if typ in (NAMESPACESXP, PACKAGESXP, PERSISTSXP):
            self._int()  # pl flags
            n = self._int()
            names = [self.read_item() for _ in range(n)]
            self.refs.append(names)
            return names
        if typ == ENVSXP:
            self._int()  # locked
            placeholder: Dict[str, Any] = {}
            self.refs.append(placeholder)
            self.read_item()  # enclos
            frame = self.read_item()
            self.read_item()  # hashtab
            self.read_item()  # attrib
            placeholder.update(_pairlist_to_dict(frame))
            return placeholder
        raise NotImplementedError(f"unhandled SEXP type {typ} at "
                                  f"offset {self.pos}")

    def _with_attrs(self, value, has_attr: bool):
        if not has_attr:
            return value
        attrs = _pairlist_to_dict(self.read_item())
        return _apply_attrs(value, attrs)


@dataclass
class _Pairlist:
    pairs: List
    tail: Any = None


def _pairlist_to_dict(pl) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    while isinstance(pl, _Pairlist):
        for tag, car in pl.pairs:
            key = tag if isinstance(tag, str) else str(tag)
            out[key] = car
        pl = pl.tail
    return out


def _apply_attrs(value, attrs: Dict[str, Any]):
    dim = attrs.get("dim")
    if dim is not None and isinstance(value, np.ndarray):
        value = value.reshape(tuple(int(d) for d in dim), order="F")
    dimnames = attrs.get("dimnames")
    names = attrs.get("names")
    extra = {k: v for k, v in attrs.items()
             if k not in ("dim",)}
    if isinstance(value, list) and isinstance(names, list) \
            and len(names) == len(value):
        return dict(zip(names, value))
    if dimnames is not None or (extra and not isinstance(value, np.ndarray)):
        return RObj(value=value, attributes=extra)
    if extra and set(extra) - {"names", "dimnames", "class"}:
        return RObj(value=value, attributes=extra)
    if dimnames is not None:
        return RObj(value=value, attributes=extra)
    return value


def _decode_altrep(info, state):
    """Decode the ALTREP classes R uses in data files: compact integer
    sequences and wrapped ('wrap_real' etc.) vectors."""
    cls = None
    if isinstance(info, _Pairlist) and info.pairs:
        cls = info.pairs[0][1]
        if isinstance(cls, list):
            cls = cls[0] if cls else None
    name = cls if isinstance(cls, str) else str(cls)
    if "compact_intseq" in name:
        n, start, step = state
        return (np.arange(int(n)) * int(step) + int(start)).astype(np.int32)
    if "compact_realseq" in name:
        n, start, step = state
        return np.arange(int(n)) * float(step) + float(start)
    if name.startswith("wrap_") or "wrap" in name:
        if isinstance(state, _Pairlist):
            return state.pairs[0][1]
        if isinstance(state, list) and state:
            return state[0]
        return state
    if "deferred_string" in name:
        if isinstance(state, _Pairlist):
            inner = state.pairs[0][1]
            return [str(x) for x in np.atleast_1d(inner)]
    raise NotImplementedError(f"unhandled ALTREP class {name!r}")


def _decompress(raw: bytes) -> bytes:
    if raw[:2] == b"\x1f\x8b":
        return gzip.decompress(raw)
    if raw[:6] == b"\xfd7zXZ\x00":
        return lzma.decompress(raw)
    if raw[:3] == b"BZh":
        return bz2.decompress(raw)
    return raw


def read_rdata(path: str) -> Dict[str, Any]:
    """Read an .rda/.RData workspace: returns {name: object}."""
    data = _decompress(open(path, "rb").read())
    if not data[:5] in (b"RDX3\n", b"RDX2\n"):
        raise ValueError(f"{path}: not an XDR RData file")
    r = _Reader(data[5:])
    magic = r._bytes(2)
    if magic != b"X\n":
        raise ValueError(f"{path}: only XDR serialization supported")
    version = r._int()
    r._int()  # writer version
    r._int()  # min reader version
    if version >= 3:
        n = r._int()  # native encoding string
        r._bytes(n)
    top = r.read_item()
    return _pairlist_to_dict(top)


def read_rds(path: str) -> Any:
    """Read a single-object .rds file."""
    data = _decompress(open(path, "rb").read())
    r = _Reader(data)
    magic = r._bytes(2)
    if magic != b"X\n":
        raise ValueError(f"{path}: only XDR serialization supported")
    version = r._int()
    r._int()
    r._int()
    if version >= 3:
        n = r._int()
        r._bytes(n)
    return r.read_item()


def unwrap(obj):
    """Strip RObj wrappers, returning the raw value."""
    return obj.value if isinstance(obj, RObj) else obj
