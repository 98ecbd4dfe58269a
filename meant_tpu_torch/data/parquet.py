"""One flat column of a Parquet file as text, on the standard library and
numpy (the card's machine has neither pandas nor pyarrow).

A Parquet file is `PAR1`, the column chunks of each row group, the footer
(a Thrift compact-protocol `FileMetaData`), the footer's length (4 bytes,
little-endian) and `PAR1` again. Each column chunk is a run of pages, each
a compact-protocol `PageHeader` followed by its body: an optional
dictionary page, then data pages (v1 or v2) whose definition levels say
which rows are null and whose values are PLAIN or indices into the
dictionary.

`read_column(path, column)` returns the `column`-th column that
`pd.read_parquet(path)` would give a DataFrame (index columns named in the
`pandas` metadata left out) as the strings `.astype(str)` makes of it:
missing values read "nan", integers with a null in the column read as
pandas' float64 strings ("1.0"; a nullable `Int*` / `UInt*` column of a
pandas frame keeps "1"), floats as numpy prints them, booleans "True" /
"False".

What it reads: the codecs UNCOMPRESSED, GZIP (zlib) and SNAPPY
(`snappy_decompress`, a raw-block decoder); the physical types BYTE_ARRAY
with a STRING / UTF8 annotation, INT32 and INT64 (signed or unsigned
annotations), FLOAT, DOUBLE and BOOLEAN, required or optional; the value
encodings PLAIN, PLAIN_DICTIONARY / RLE_DICTIONARY and RLE (booleans).
Anything else raises NotImplementedError naming it: the other codecs (the
standard library has no zstd, lz4, brotli or lzo), the DELTA_* and
BYTE_STREAM_SPLIT encodings, FIXED_LEN_BYTE_ARRAY, INT96, BYTE_ARRAY with
no string annotation, the DECIMAL, DATE, TIME and TIMESTAMP annotations,
nested columns, integer columns whose pandas metadata names another type
(a timedelta or a period), and columns whose type in the `ARROW:schema`
metadata is not an integer, float, bool or string (a duration, which
Parquet stores as an INT64 with no annotation). A file that is not Parquet
or is cut short raises ValueError naming the path.
"""

from __future__ import annotations

import base64
import json
import os
import re
import struct
import zlib
from typing import List

import numpy as np

MAGIC = b"PAR1"

# parquet.thrift's enums
TYPES = ("BOOLEAN", "INT32", "INT64", "INT96", "FLOAT", "DOUBLE",
         "BYTE_ARRAY", "FIXED_LEN_BYTE_ARRAY")
CODECS = ("UNCOMPRESSED", "SNAPPY", "GZIP", "LZO", "BROTLI", "LZ4", "ZSTD",
          "LZ4_RAW")
ENCODINGS = ("PLAIN", "GROUP_VAR_INT", "PLAIN_DICTIONARY", "RLE",
             "BIT_PACKED", "DELTA_BINARY_PACKED", "DELTA_LENGTH_BYTE_ARRAY",
             "DELTA_BYTE_ARRAY", "RLE_DICTIONARY", "BYTE_STREAM_SPLIT")
CONVERTED = ("UTF8", "MAP", "MAP_KEY_VALUE", "LIST", "ENUM", "DECIMAL",
             "DATE", "TIME_MILLIS", "TIME_MICROS", "TIMESTAMP_MILLIS",
             "TIMESTAMP_MICROS", "UINT_8", "UINT_16", "UINT_32", "UINT_64",
             "INT_8", "INT_16", "INT_32", "INT_64", "JSON", "BSON",
             "INTERVAL")
LOGICAL = {1: "STRING", 2: "MAP", 3: "LIST", 4: "ENUM", 5: "DECIMAL",
           6: "DATE", 7: "TIME", 8: "TIMESTAMP", 10: "INTEGER",
           11: "UNKNOWN", 12: "JSON", 13: "BSON", 14: "UUID", 15: "FLOAT16",
           16: "VARIANT", 17: "GEOMETRY", 18: "GEOGRAPHY"}
PAGES = ("DATA_PAGE", "INDEX_PAGE", "DICTIONARY_PAGE", "DATA_PAGE_V2")
# Arrow's Schema.fbs `Type` union, and the members this reader prints as
# pandas does
ARROW_TYPES = ("NONE", "Null", "Int", "FloatingPoint", "Binary", "Utf8",
               "Bool", "Decimal", "Date", "Time", "Timestamp", "Interval",
               "List", "Struct_", "Union", "FixedSizeBinary",
               "FixedSizeList", "Map", "Duration", "LargeBinary",
               "LargeUtf8", "LargeList", "RunEndEncoded", "BinaryView",
               "Utf8View", "ListView", "LargeListView")
ARROW_READ = ("Int", "FloatingPoint", "Utf8", "Bool", "LargeUtf8",
              "Utf8View")
PLAIN, PLAIN_DICTIONARY, RLE, RLE_DICTIONARY = 0, 2, 3, 8
REQUIRED, OPTIONAL = 0, 1

# the physical types' PLAIN widths as numpy dtypes (signed, unsigned)
FIXED = {"INT32": ("<i4", "<u4"), "INT64": ("<i8", "<u8"),
         "FLOAT": ("<f4", "<f4"), "DOUBLE": ("<f8", "<f8")}
# pandas metadata's numpy_type of an integer column pandas reads as one
PANDAS_INT = re.compile(r"(?i)u?int(8|16|32|64)$")
MAX_DEPTH = 64


def _name(table, i) -> str:
    """Enum value `i`'s name in `table` (a tuple or a dict), or its
    number."""
    try:
        return table[i]
    except (IndexError, KeyError):
        return f"#{i}"


# ---- the Thrift compact protocol ------------------------------------------

class _Thrift:
    """Reads compact-protocol values from `buf`. A struct comes back as
    {field id: value}, so a caller takes the fields it uses and every
    other field, of any type or id, is read past."""

    def __init__(self, buf):
        self.buf, self.pos, self.end = buf, 0, len(buf)

    def take(self, n: int):
        if n < 0 or self.pos + n > self.end:
            raise ValueError("Thrift data runs past its buffer")
        self.pos += n
        return self.buf[self.pos - n: self.pos]

    def byte(self) -> int:
        if self.pos >= self.end:
            raise ValueError("Thrift data runs past its buffer")
        self.pos += 1
        return self.buf[self.pos - 1]

    def varint(self) -> int:
        out = shift = 0
        while True:
            b = self.byte()
            out |= (b & 0x7F) << shift
            if b < 0x80:
                return out
            shift += 7
            if shift > 63:
                raise ValueError("Thrift varint longer than 10 bytes")

    def zigzag(self) -> int:
        n = self.varint()
        return (n >> 1) ^ -(n & 1)

    def value(self, ttype: int, depth: int):
        if ttype in (1, 2):          # a bool inside a list, set or map
            return self.byte() == 1
        if ttype == 3:
            return struct.unpack("<b", self.take(1))[0]
        if ttype in (4, 5, 6):
            return self.zigzag()
        if ttype == 7:
            return struct.unpack("<d", self.take(8))[0]
        if ttype == 8:
            return bytes(self.take(self.varint()))
        if ttype in (9, 10):
            head = self.byte()
            size = head >> 4
            if size == 15:
                size = self.varint()
            return [self.value(head & 0x0F, depth + 1) for _ in range(size)]
        if ttype == 11:
            size = self.varint()
            if not size:
                return {}
            kv = self.byte()
            return dict((self.value(kv >> 4, depth + 1),
                         self.value(kv & 0x0F, depth + 1))
                        for _ in range(size))
        if ttype == 12:
            return self.struct(depth + 1)
        raise ValueError(f"unknown Thrift compact type {ttype}")

    def struct(self, depth: int = 0) -> dict:
        if depth > MAX_DEPTH:
            raise ValueError("Thrift structs nested too deep")
        out, last = {}, 0
        while True:
            head = self.byte()
            if head == 0:
                return out
            delta, ttype = head >> 4, head & 0x0F
            last = last + delta if delta else self.zigzag()
            if ttype in (1, 2):      # a bool field carries its value
                out[last] = ttype == 1
            else:
                out[last] = self.value(ttype, depth)


# ---- the Arrow schema -------------------------------------------------------

class _Flat:
    """Reads tables of a FlatBuffers buffer: a table's field `i` is found
    through the vtable its first 4 bytes point back to."""

    def __init__(self, buf: bytes):
        self.buf = buf

    def u(self, fmt: str, pos: int) -> int:
        return struct.unpack_from(fmt, self.buf, pos)[0]

    def field(self, table: int, i: int):
        """The position of table field `i`'s value, or None if absent."""
        vtable = table - self.u("<i", table)
        if 4 + 2 * i >= self.u("<H", vtable):
            return None
        off = self.u("<H", vtable + 4 + 2 * i)
        return table + off if off else None

    def table(self, table: int, i: int):
        """The table that field `i` of `table` points to, or None."""
        pos = self.field(table, i)
        return None if pos is None else pos + self.u("<I", pos)

    def vector(self, table: int, i: int) -> list:
        """The tables of field `i`, a vector of tables."""
        start = self.table(table, i)
        if start is None:
            return []
        return [start + 4 + 4 * k + self.u("<I", start + 4 + 4 * k)
                for k in range(self.u("<I", start))]


def _arrow_types(blob: bytes, path: str) -> List[str]:
    """The type of each top-level field of the `ARROW:schema` metadata
    (base64 of an Arrow IPC Schema message) by Schema.fbs's names."""
    try:
        raw = base64.b64decode(blob)
        # the IPC message's prefix: 0xFFFFFFFF and a length, or (before
        # Arrow 0.15) a length alone
        fb = _Flat(raw[8:] if raw[:4] == b"\xff\xff\xff\xff" else raw[4:])
        message = fb.u("<I", 0)
        if fb.field(message, 1) is None or \
                fb.u("<B", fb.field(message, 1)) != 1:     # Schema
            raise ValueError("not a Schema message")
        schema = fb.table(message, 2)
        out = []
        for field in fb.vector(schema, 1):
            pos = fb.field(field, 2)
            out.append(_name(ARROW_TYPES, 0 if pos is None
                             else fb.u("<B", pos)))
        return out
    except (ValueError, struct.error) as e:
        raise ValueError(f"{path}: unreadable ARROW:schema metadata "
                         f"({e})") from None


# ---- codecs -------------------------------------------------------------

def snappy_decompress(data) -> bytes:
    """A raw Snappy block (Parquet compresses each page as one): the
    uncompressed length as a varint, then literals (a length in the tag or
    in 1-4 bytes after it) and copies with 1-, 2- and 4-byte offsets, a
    copy longer than its offset repeating the bytes it reads."""
    src = bytes(data)
    end = len(src)
    reader = _Thrift(src)
    n = reader.varint()
    pos, out = reader.pos, bytearray()
    while pos < end:
        tag = src[pos]
        pos += 1
        kind = tag & 3
        if kind == 0:
            length = tag >> 2
            if length >= 60:
                extra = length - 59
                if pos + extra > end:
                    raise ValueError("snappy literal length cut short")
                length = int.from_bytes(src[pos:pos + extra], "little")
                pos += extra
            length += 1
            if pos + length > end:
                raise ValueError("snappy literal runs past the block")
            out += src[pos:pos + length]
            pos += length
            continue
        width = (1, 2, 4)[kind - 1]
        if pos + width > end:
            raise ValueError("snappy copy offset cut short")
        if kind == 1:
            length = 4 + ((tag >> 2) & 7)
            offset = ((tag >> 5) << 8) | src[pos]
        else:
            length = (tag >> 2) + 1
            offset = int.from_bytes(src[pos:pos + width], "little")
        pos += width
        start = len(out) - offset
        if offset == 0 or start < 0:
            raise ValueError(f"snappy copy offset {offset} outside the "
                             f"{len(out)} bytes written")
        if offset >= length:
            out += out[start:start + length]
        else:
            out += (out[start:] * (length // offset + 1))[:length]
        if len(out) > n:
            break
    if len(out) != n:
        raise ValueError(f"snappy block gives {len(out)} bytes, its "
                         f"preamble says {n}")
    return bytes(out)


def _decompress(codec: int, data, size: int, where: str) -> bytes:
    """A page body in `codec`, checked against the `size` its header
    gives; `where` names the file and column in an error."""
    name = _name(CODECS, codec)
    if name == "UNCOMPRESSED":
        out = bytes(data)
    elif name == "SNAPPY":
        out = snappy_decompress(data)
    elif name == "GZIP":
        try:
            out = zlib.decompress(bytes(data), 47)   # gzip or zlib header
        except zlib.error as e:
            raise ValueError(f"{where}: GZIP page: {e}") from None
    else:
        raise NotImplementedError(
            f"{where}: the {name} codec is not supported (UNCOMPRESSED, "
            f"SNAPPY and GZIP are)")
    if len(out) != size:
        raise ValueError(f"{where}: {name} page decompresses to {len(out)} "
                         f"bytes, its header says {size}")
    return out


# ---- levels and values ----------------------------------------------------

def _unpack(buf, bit_width: int, count: int) -> np.ndarray:
    """`count` little-endian bit-packed values of `bit_width` bits."""
    if bit_width == 0:
        return np.zeros(count, np.int64)
    bits = np.unpackbits(np.frombuffer(buf, np.uint8), bitorder="little")
    bits = bits[:count * bit_width].reshape(count, bit_width)
    return bits.astype(np.int64) @ (np.int64(1) << np.arange(
        bit_width, dtype=np.int64))


def _hybrid(buf, bit_width: int, count: int) -> np.ndarray:
    """`count` values of the RLE / bit-packed hybrid in `buf` (no length
    prefix): runs of one repeated value, and groups of 8 bit-packed
    ones."""
    reader, runs, n = _Thrift(buf), [], 0
    value_bytes = (bit_width + 7) // 8
    while n < count:
        header = reader.varint()
        if header & 1:
            groups = header >> 1
            runs.append(_unpack(reader.take(groups * bit_width), bit_width,
                                groups * 8))
            n += groups * 8
        else:
            run = header >> 1
            runs.append(np.full(run, int.from_bytes(
                reader.take(value_bytes), "little"), np.int64))
            n += run
    return np.concatenate(runs)[:count] if runs else np.zeros(0, np.int64)


def _prefixed(buf) -> tuple:
    """A 4-byte little-endian length and the bytes it covers; the rest."""
    if len(buf) < 4:
        raise ValueError("length prefix cut short")
    size = struct.unpack_from("<I", buf)[0]
    if 4 + size > len(buf):
        raise ValueError("length-prefixed run past its page")
    return buf[4:4 + size], buf[4 + size:]


def _plain(buf, ptype: str, dtype: str, count: int):
    """`count` PLAIN values: an array, or a list of str for BYTE_ARRAY."""
    if ptype == "BYTE_ARRAY":
        out, pos, end = [], 0, len(buf)
        for _ in range(count):
            if pos + 4 > end:
                raise ValueError("BYTE_ARRAY value cut short")
            size = struct.unpack_from("<I", buf, pos)[0]
            pos += 4
            if pos + size > end:
                raise ValueError("BYTE_ARRAY value cut short")
            out.append(bytes(buf[pos:pos + size]).decode("utf-8"))
            pos += size
        return out
    if ptype == "BOOLEAN":
        if (count + 7) // 8 > len(buf):
            raise ValueError("BOOLEAN values cut short")
        return _unpack(buf[:(count + 7) // 8], 1, count).astype(bool)
    width = np.dtype(dtype).itemsize
    if count * width > len(buf):
        raise ValueError(f"{ptype} values cut short")
    return np.frombuffer(buf, dtype, count)


class Column:
    """A leaf of the schema that `read_column` can turn into text."""

    def __init__(self, path: str, element: dict, pandas: dict,
                 arrow: str = None):
        self.name = element[4].decode("utf-8")
        self.path, self.where = path, f"{path}: column {self.name!r}"
        self.ptype = _name(TYPES, element.get(1, -1))
        self.optional = element.get(3, REQUIRED) == OPTIONAL
        logical, converted = element.get(10), element.get(6)
        if logical:
            annotation = _name(LOGICAL, next(iter(logical)))
        elif converted is not None:
            annotation = _name(CONVERTED, converted)
        else:
            annotation = None
        unsigned = False
        if self.ptype == "BYTE_ARRAY":
            if annotation not in ("STRING", "UTF8"):
                raise NotImplementedError(
                    f"{self.where} is BYTE_ARRAY "
                    + (f"with the {annotation} annotation" if annotation
                       else "without a string annotation")
                    + "; only STRING / UTF8 byte arrays are read")
        elif self.ptype not in FIXED and self.ptype != "BOOLEAN":
            raise NotImplementedError(
                f"{self.where} has the physical type {self.ptype}, which is "
                f"not supported")
        elif annotation == "INTEGER" and self.ptype.startswith("INT"):
            unsigned = not logical[10].get(2, True)
        elif annotation in CONVERTED[11:19] and self.ptype.startswith("INT"):
            unsigned = annotation.startswith("U")
        elif annotation is not None:
            raise NotImplementedError(
                f"{self.where}: the {annotation} annotation on "
                f"{self.ptype} is not supported")
        self.dtype = FIXED.get(self.ptype, (None, None))[unsigned]
        # pandas reads an integer column with a null as float64, but for
        # its nullable extension dtypes (numpy_type "Int64", "UInt8", ...)
        numpy_type = pandas.get(self.name)
        if numpy_type is not None and self.ptype.startswith("INT") and \
                not PANDAS_INT.match(numpy_type):
            raise NotImplementedError(
                f"{self.where}: pandas metadata names the type {numpy_type}, "
                f"which is not supported")
        self.nullable_int = bool(numpy_type) and numpy_type[0] in "IU"
        # pandas reads an Arrow type by the file's Arrow schema
        if arrow is not None and arrow not in ARROW_READ:
            raise NotImplementedError(
                f"{self.where}: the Arrow type {arrow} is not supported")

    def pages(self, chunk: bytes, codec: int, num_values: int):
        """(valid, values) of each data page of a column chunk: `valid`
        is None when the page has no nulls."""
        reader, dictionary, seen = _Thrift(chunk), None, 0
        while seen < num_values:
            if reader.pos >= len(chunk):
                raise ValueError(f"{self.path}: column {self.name!r} ends "
                                 f"after {seen} of {num_values} values")
            header = reader.struct()
            kind = _name(PAGES, header.get(1, -1))
            size, body_size = header.get(2, 0), header.get(3, 0)
            body = reader.take(body_size)
            if kind == "INDEX_PAGE":
                continue
            if kind == "DICTIONARY_PAGE":
                # its entries are PLAIN; a format-1.0 writer labels the
                # page PLAIN_DICTIONARY
                dph = header[7]
                if dph.get(2, PLAIN) not in (PLAIN, PLAIN_DICTIONARY):
                    raise NotImplementedError(
                        f"{self.where}: a dictionary page in "
                        f"{_name(ENCODINGS, dph[2])} is not supported")
                dictionary = self.values(
                    _decompress(codec, body, size, self.where), PLAIN,
                    dph[1], None)
                if isinstance(dictionary, list):
                    dictionary = np.asarray(dictionary, object)
                continue
            if kind == "DATA_PAGE":
                dph = header[5]
                count, encoding = dph[1], dph[2]
                data = _decompress(codec, body, size, self.where)
                levels = None
                if self.optional:
                    if dph.get(3, RLE) != RLE:
                        raise NotImplementedError(
                            f"{self.path}: definition levels in "
                            f"{_name(ENCODINGS, dph[3])} are not supported")
                    levels, data = _prefixed(data)
            elif kind == "DATA_PAGE_V2":
                dph = header[8]
                count, encoding = dph[1], dph[4]
                rep, dlen = dph.get(6, 0), dph.get(5, 0)
                if rep or rep + dlen > body_size:
                    raise ValueError(f"{self.path}: bad level lengths in a "
                                     f"v2 page of {self.name!r}")
                levels = body[:dlen] if self.optional else None
                data = body[dlen:]
                if dph.get(7, True):
                    data = _decompress(codec, data, size - dlen,
                                       self.where)
                elif len(data) != size - dlen:
                    raise ValueError(f"{self.path}: a v2 page of "
                                     f"{self.name!r} holds {len(data)} "
                                     f"value bytes, its header says "
                                     f"{size - dlen}")
            else:
                raise NotImplementedError(f"{self.path}: page type {kind}")
            valid = None
            if levels is not None:
                valid = _hybrid(levels, 1, count) == 1
                n = int(valid.sum())
                if valid.all():
                    valid = None
            else:
                n = count
            yield valid, self.values(data, encoding, n, dictionary)
            seen += count

    def values(self, data, encoding: int, count: int, dictionary):
        """`count` values of a page body in `encoding`."""
        name = _name(ENCODINGS, encoding)
        if encoding == PLAIN:
            return _plain(data, self.ptype, self.dtype, count)
        if encoding in (PLAIN_DICTIONARY, RLE_DICTIONARY):
            if dictionary is None:
                raise ValueError(f"{self.path}: {name} page of "
                                 f"{self.name!r} before its dictionary")
            if not data:
                raise ValueError(f"{self.path}: empty {name} page")
            index = _hybrid(data[1:], data[0], count)
            if count and index.max() >= len(dictionary):
                raise ValueError(f"{self.path}: dictionary index past the "
                                 f"{len(dictionary)} entries of "
                                 f"{self.name!r}")
            values = dictionary[index]
            return values.tolist() if values.dtype == object else values
        if encoding == RLE and self.ptype == "BOOLEAN":
            run, _ = _prefixed(data)
            return _hybrid(run, 1, count).astype(bool)
        raise NotImplementedError(
            f"{self.path}: column {self.name!r} uses the {name} encoding, "
            f"which is not supported (PLAIN, PLAIN_DICTIONARY, "
            f"RLE_DICTIONARY and RLE booleans are)")

    def texts(self, pages: list) -> List[str]:
        """The column as pandas' astype(str) gives it, missing as "nan"."""
        if not pages:
            return []
        valid = np.concatenate([
            np.ones(len(v), bool) if ok is None else ok for ok, v in pages])
        if self.ptype == "BYTE_ARRAY":
            values = [t for _, v in pages for t in v]
        else:
            values = np.concatenate([v for _, v in pages])
            if self.ptype == "BOOLEAN":
                values = np.where(values, "True", "False").tolist()
            elif self.ptype in ("FLOAT", "DOUBLE"):
                values = [str(x) for x in values]
            elif not valid.all() and not self.nullable_int:
                values = [str(x) for x in values.astype(np.float64)]
            else:
                values = [str(x) for x in values.tolist()]
        if valid.all():
            return list(values)
        out = np.full(len(valid), "nan", object)
        out[valid] = np.asarray(values, object)
        return out.tolist()


def _footer(f, path: str, size: int) -> dict:
    if size < 12:
        raise ValueError(f"{path}: {size} bytes is too short for Parquet")
    f.seek(0)
    head = f.read(4)
    f.seek(size - 8)
    tail = f.read(8)
    if head != MAGIC or tail[4:] != MAGIC:
        raise ValueError(f"{path}: no PAR1 magic at both ends; not a "
                         f"Parquet file, or cut short")
    length = struct.unpack("<I", tail[:4])[0]
    if length > size - 12:
        raise ValueError(f"{path}: footer length {length} exceeds the "
                         f"{size}-byte file")
    f.seek(size - 8 - length)
    return _Thrift(f.read(length)).struct()


def _leaves(schema: list, path: str) -> list:
    """(schema element, index of its first leaf, is a group) of each
    top-level field."""
    if not schema:
        raise ValueError(f"{path}: empty schema")
    out, i, leaf = [], 1, 0
    for _ in range(schema[0].get(5, 0)):
        if i >= len(schema):
            raise ValueError(f"{path}: schema ends early")
        top, first, todo = schema[i], leaf, 1
        while todo:             # walk this field's subtree
            if i >= len(schema):
                raise ValueError(f"{path}: schema ends early")
            children = schema[i].get(5, 0)
            todo += children - 1
            leaf += children == 0
            i += 1
        out.append((top, first, bool(top.get(5, 0))))
    return out


def read_column(path: str, column: int = 0) -> List[str]:
    """The `column`-th non-index column of the Parquet file at `path` as
    `pd.read_parquet(path).iloc[:, column].astype(str)` gives it, every
    row group and page in order, a missing value as "nan"."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        meta = _footer(f, path, size)
        pandas, index_columns, arrow = {}, set(), None
        for kv in meta.get(5, []):
            if kv.get(1) == b"ARROW:schema":
                arrow = _arrow_types(kv.get(2, b""), path)
            if kv.get(1) == b"pandas":
                md = json.loads(kv.get(2, b"{}"))
                index_columns = {c for c in md.get("index_columns", [])
                                 if isinstance(c, str)}
                pandas = {c.get("field_name"): c.get("numpy_type")
                          for c in md.get("columns", [])}
        top = _leaves(meta.get(2, []), path)
        if arrow is not None and len(arrow) != len(top):
            raise ValueError(f"{path}: ARROW:schema has {len(arrow)} "
                             f"fields, the Parquet schema {len(top)}")
        fields = [(i,) + field for i, field in enumerate(top)
                  if field[0][4].decode("utf-8") not in index_columns]
        if not -len(fields) <= column < len(fields):
            raise IndexError(f"{path}: no column {column} among "
                             f"{len(fields)}")
        i, element, leaf, group = fields[column]
        name = element[4].decode("utf-8")
        if group or element.get(3) == 2:
            raise NotImplementedError(
                f"{path}: column {name!r} is nested (a group or repeated "
                f"field); only flat columns are read")
        col = Column(path, element, pandas,
                     None if arrow is None else arrow[i])
        pages = []
        for group_meta in meta.get(4, []):
            chunks = group_meta.get(1, [])
            if leaf >= len(chunks):
                raise ValueError(f"{path}: a row group lacks column "
                                 f"{name!r}")
            chunk = chunks[leaf]
            if chunk.get(1) is not None:
                raise NotImplementedError(
                    f"{path}: column {name!r} lies in another file "
                    f"({chunk[1].decode('utf-8')})")
            cm = chunk[3]
            if not cm[5]:           # no values, perhaps no data page
                continue
            start, length = cm.get(11) or cm[9], cm[7]
            if start < 4 or start + length > size - 8:
                raise ValueError(f"{path}: column {name!r}'s chunk lies "
                                 f"outside the file")
            f.seek(start)
            pages += col.pages(f.read(length), cm[4], cm[5])
    return col.texts(pages)
