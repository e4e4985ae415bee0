"""HPACK header compression (RFC 7541): a copy of
``linkerd_tpu/protocol/h2/hpack.py`` that codes Huffman strings in
Python only (the reference's native Huffman coder is not bound here).

Reference parity: the reference delegates HPACK to Netty's codec inside its
patched H2FrameCodec (finagle/h2/.../netty4/H2FrameCodec.scala); here it is
implemented natively: static + dynamic tables, integer/string primitives,
and the Appendix-B Huffman code (decode always supported; encoding is
optional and off by default — sending literal strings is always legal).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

class HpackError(Exception):
    """A COMPRESSION_ERROR-grade decoding failure (RFC 7540 §4.3)."""


# RFC 7541 Appendix A — the 61-entry static table.
STATIC_TABLE: List[Tuple[str, str]] = [
    (":authority", ""),
    (":method", "GET"),
    (":method", "POST"),
    (":path", "/"),
    (":path", "/index.html"),
    (":scheme", "http"),
    (":scheme", "https"),
    (":status", "200"),
    (":status", "204"),
    (":status", "206"),
    (":status", "304"),
    (":status", "400"),
    (":status", "404"),
    (":status", "500"),
    ("accept-charset", ""),
    ("accept-encoding", "gzip, deflate"),
    ("accept-language", ""),
    ("accept-ranges", ""),
    ("accept", ""),
    ("access-control-allow-origin", ""),
    ("age", ""),
    ("allow", ""),
    ("authorization", ""),
    ("cache-control", ""),
    ("content-disposition", ""),
    ("content-encoding", ""),
    ("content-language", ""),
    ("content-length", ""),
    ("content-location", ""),
    ("content-range", ""),
    ("content-type", ""),
    ("cookie", ""),
    ("date", ""),
    ("etag", ""),
    ("expect", ""),
    ("expires", ""),
    ("from", ""),
    ("host", ""),
    ("if-match", ""),
    ("if-modified-since", ""),
    ("if-none-match", ""),
    ("if-range", ""),
    ("if-unmodified-since", ""),
    ("last-modified", ""),
    ("link", ""),
    ("location", ""),
    ("max-forwards", ""),
    ("proxy-authenticate", ""),
    ("proxy-authorization", ""),
    ("range", ""),
    ("referer", ""),
    ("refresh", ""),
    ("retry-after", ""),
    ("server", ""),
    ("set-cookie", ""),
    ("strict-transport-security", ""),
    ("transfer-encoding", ""),
    ("user-agent", ""),
    ("vary", ""),
    ("via", ""),
    ("www-authenticate", ""),
]

_STATIC_FULL: Dict[Tuple[str, str], int] = {}
_STATIC_NAME: Dict[str, int] = {}
for _i, (_n, _v) in enumerate(STATIC_TABLE):
    _STATIC_FULL.setdefault((_n, _v), _i + 1)
    _STATIC_NAME.setdefault(_n, _i + 1)


# RFC 7541 Appendix B — Huffman code: (code, bit-length) per symbol 0..256
# (256 = EOS). Correctness is asserted by the Kraft-equality self-check at
# import and by curl/grpc interop tests (their nghttp2 peers always encode).
HUFFMAN_TABLE: List[Tuple[int, int]] = [
    (0x1ff8, 13), (0x7fffd8, 23), (0xfffffe2, 28), (0xfffffe3, 28),
    (0xfffffe4, 28), (0xfffffe5, 28), (0xfffffe6, 28), (0xfffffe7, 28),
    (0xfffffe8, 28), (0xffffea, 24), (0x3ffffffc, 30), (0xfffffe9, 28),
    (0xfffffea, 28), (0x3ffffffd, 30), (0xfffffeb, 28), (0xfffffec, 28),
    (0xfffffed, 28), (0xfffffee, 28), (0xfffffef, 28), (0xffffff0, 28),
    (0xffffff1, 28), (0xffffff2, 28), (0x3ffffffe, 30), (0xffffff3, 28),
    (0xffffff4, 28), (0xffffff5, 28), (0xffffff6, 28), (0xffffff7, 28),
    (0xffffff8, 28), (0xffffff9, 28), (0xffffffa, 28), (0xffffffb, 28),
    (0x14, 6), (0x3f8, 10), (0x3f9, 10), (0xffa, 12),
    (0x1ff9, 13), (0x15, 6), (0xf8, 8), (0x7fa, 11),
    (0x3fa, 10), (0x3fb, 10), (0xf9, 8), (0x7fb, 11),
    (0xfa, 8), (0x16, 6), (0x17, 6), (0x18, 6),
    (0x0, 5), (0x1, 5), (0x2, 5), (0x19, 6),
    (0x1a, 6), (0x1b, 6), (0x1c, 6), (0x1d, 6),
    (0x1e, 6), (0x1f, 6), (0x5c, 7), (0xfb, 8),
    (0x7ffc, 15), (0x20, 6), (0xffb, 12), (0x3fc, 10),
    (0x1ffa, 13), (0x21, 6), (0x5d, 7), (0x5e, 7),
    (0x5f, 7), (0x60, 7), (0x61, 7), (0x62, 7),
    (0x63, 7), (0x64, 7), (0x65, 7), (0x66, 7),
    (0x67, 7), (0x68, 7), (0x69, 7), (0x6a, 7),
    (0x6b, 7), (0x6c, 7), (0x6d, 7), (0x6e, 7),
    (0x6f, 7), (0x70, 7), (0x71, 7), (0x72, 7),
    (0xfc, 8), (0x73, 7), (0xfd, 8), (0x1ffb, 13),
    (0x7fff0, 19), (0x1ffc, 13), (0x3ffc, 14), (0x22, 6),
    (0x7ffd, 15), (0x3, 5), (0x23, 6), (0x4, 5),
    (0x24, 6), (0x5, 5), (0x25, 6), (0x26, 6),
    (0x27, 6), (0x6, 5), (0x74, 7), (0x75, 7),
    (0x28, 6), (0x29, 6), (0x2a, 6), (0x7, 5),
    (0x2b, 6), (0x76, 7), (0x2c, 6), (0x8, 5),
    (0x9, 5), (0x2d, 6), (0x77, 7), (0x78, 7),
    (0x79, 7), (0x7a, 7), (0x7b, 7), (0x7ffe, 15),
    (0x7fc, 11), (0x3ffd, 14), (0x1ffd, 13), (0xffffffc, 28),
    (0xfffe6, 20), (0x3fffd2, 22), (0xfffe7, 20), (0xfffe8, 20),
    (0x3fffd3, 22), (0x3fffd4, 22), (0x3fffd5, 22), (0x7fffd9, 23),
    (0x3fffd6, 22), (0x7fffda, 23), (0x7fffdb, 23), (0x7fffdc, 23),
    (0x7fffdd, 23), (0x7fffde, 23), (0xffffeb, 24), (0x7fffdf, 23),
    (0xffffec, 24), (0xffffed, 24), (0x3fffd7, 22), (0x7fffe0, 23),
    (0xffffee, 24), (0x7fffe1, 23), (0x7fffe2, 23), (0x7fffe3, 23),
    (0x7fffe4, 23), (0x1fffdc, 21), (0x3fffd8, 22), (0x7fffe5, 23),
    (0x3fffd9, 22), (0x7fffe6, 23), (0x7fffe7, 23), (0xffffef, 24),
    (0x3fffda, 22), (0x1fffdd, 21), (0xfffe9, 20), (0x3fffdb, 22),
    (0x3fffdc, 22), (0x7fffe8, 23), (0x7fffe9, 23), (0x1fffde, 21),
    (0x7fffea, 23), (0x3fffdd, 22), (0x3fffde, 22), (0xfffff0, 24),
    (0x1fffdf, 21), (0x3fffdf, 22), (0x7fffeb, 23), (0x7fffec, 23),
    (0x1fffe0, 21), (0x1fffe1, 21), (0x3fffe0, 22), (0x1fffe2, 21),
    (0x7fffed, 23), (0x3fffe1, 22), (0x7fffee, 23), (0x7fffef, 23),
    (0xfffea, 20), (0x3fffe2, 22), (0x3fffe3, 22), (0x3fffe4, 22),
    (0x7ffff0, 23), (0x3fffe5, 22), (0x3fffe6, 22), (0x7ffff1, 23),
    (0x3ffffe0, 26), (0x3ffffe1, 26), (0xfffeb, 20), (0x7fff1, 19),
    (0x3fffe7, 22), (0x7ffff2, 23), (0x3fffe8, 22), (0x1ffffec, 25),
    (0x3ffffe2, 26), (0x3ffffe3, 26), (0x3ffffe4, 26), (0x7ffffde, 27),
    (0x7ffffdf, 27), (0x3ffffe5, 26), (0xfffff1, 24), (0x1ffffed, 25),
    (0x7fff2, 19), (0x1fffe3, 21), (0x3ffffe6, 26), (0x7ffffe0, 27),
    (0x7ffffe1, 27), (0x3ffffe7, 26), (0x7ffffe2, 27), (0xfffff2, 24),
    (0x1fffe4, 21), (0x1fffe5, 21), (0x3ffffe8, 26), (0x3ffffe9, 26),
    (0xffffffd, 28), (0x7ffffe3, 27), (0x7ffffe4, 27), (0x7ffffe5, 27),
    (0xfffec, 20), (0xfffff3, 24), (0xfffed, 20), (0x1fffe6, 21),
    (0x3fffe9, 22), (0x1fffe7, 21), (0x1fffe8, 21), (0x7ffff3, 23),
    (0x3fffea, 22), (0x3fffeb, 22), (0x1ffffee, 25), (0x1ffffef, 25),
    (0xfffff4, 24), (0xfffff5, 24), (0x3ffffea, 26), (0x7ffff4, 23),
    (0x3ffffeb, 26), (0x7ffffe6, 27), (0x3ffffec, 26), (0x3ffffed, 26),
    (0x7ffffe7, 27), (0x7ffffe8, 27), (0x7ffffe9, 27), (0x7ffffea, 27),
    (0x7ffffeb, 27), (0xffffffe, 28), (0x7ffffec, 27), (0x7ffffed, 27),
    (0x7ffffee, 27), (0x7ffffef, 27), (0x7fffff0, 27), (0x3ffffee, 26),
    (0x3fffffff, 30),
]

# Canonical-code self-check: a complete prefix code satisfies Kraft equality.
assert len(HUFFMAN_TABLE) == 257
assert abs(sum(2.0 ** -bits for _, bits in HUFFMAN_TABLE) - 1.0) < 1e-9, \
    "huffman table is not a complete prefix code"


def _build_decode_tree() -> list:
    # Binary trie as nested [left, right]; leaves are symbol ints.
    root: list = [None, None]
    for sym, (code, bits) in enumerate(HUFFMAN_TABLE):
        node = root
        for i in range(bits - 1, -1, -1):
            b = (code >> i) & 1
            if i == 0:
                node[b] = sym
            else:
                if node[b] is None:
                    node[b] = [None, None]
                node = node[b]
    return root


_DECODE_TREE = _build_decode_tree()


def huffman_decode(data: bytes) -> bytes:
    out = bytearray()
    node = _DECODE_TREE
    # Track bits consumed since the last emitted symbol for padding checks.
    pad_bits = 0
    pad_ones = True
    for byte in data:
        for i in range(7, -1, -1):
            b = (byte >> i) & 1
            pad_bits += 1
            pad_ones = pad_ones and b == 1
            nxt = node[b]
            if nxt is None:
                raise HpackError("invalid huffman sequence")
            if isinstance(nxt, int):
                if nxt == 256:
                    raise HpackError("EOS symbol in huffman data")
                out.append(nxt)
                node = _DECODE_TREE
                pad_bits = 0
                pad_ones = True
            else:
                node = nxt
    # RFC 7541 §5.2: padding must be <8 bits of the EOS prefix (all ones).
    if pad_bits >= 8 or not pad_ones:
        raise HpackError("invalid huffman padding")
    return bytes(out)


def huffman_encode(data: bytes) -> bytes:
    acc = 0
    nbits = 0
    out = bytearray()
    for byte in data:
        code, bits = HUFFMAN_TABLE[byte]
        acc = (acc << bits) | code
        nbits += bits
        while nbits >= 8:
            nbits -= 8
            out.append((acc >> nbits) & 0xFF)
    if nbits:
        # pad with EOS-prefix ones
        out.append(((acc << (8 - nbits)) | ((1 << (8 - nbits)) - 1)) & 0xFF)
    return bytes(out)


def encode_int(value: int, prefix_bits: int, flags: int = 0) -> bytes:
    """RFC 7541 §5.1 integer representation."""
    limit = (1 << prefix_bits) - 1
    if value < limit:
        return bytes([flags | value])
    out = bytearray([flags | limit])
    value -= limit
    while value >= 128:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    out.append(value)
    return bytes(out)


def decode_int(data: bytes, pos: int, prefix_bits: int) -> Tuple[int, int]:
    if pos >= len(data):
        raise HpackError("truncated integer")
    limit = (1 << prefix_bits) - 1
    value = data[pos] & limit
    pos += 1
    if value < limit:
        return value, pos
    shift = 0
    while True:
        if pos >= len(data):
            raise HpackError("truncated integer continuation")
        b = data[pos]
        pos += 1
        value += (b & 0x7F) << shift
        shift += 7
        if shift > 35:
            raise HpackError("integer overflow")
        if not (b & 0x80):
            return value, pos


def _decode_string(data: bytes, pos: int) -> Tuple[str, int]:
    if pos >= len(data):
        raise HpackError("truncated string")
    huff = bool(data[pos] & 0x80)
    length, pos = decode_int(data, pos, 7)
    if pos + length > len(data):
        raise HpackError("truncated string data")
    raw = data[pos:pos + length]
    pos += length
    if huff:
        raw = huffman_decode(raw)
    try:
        return raw.decode("utf-8"), pos
    except UnicodeDecodeError:
        return raw.decode("latin-1"), pos


def _encode_string(s: str, huffman: bool) -> bytes:
    raw = s.encode("utf-8")
    if huffman:
        enc = huffman_encode(raw)
        if len(enc) < len(raw):
            return encode_int(len(enc), 7, 0x80) + enc
    return encode_int(len(raw), 7, 0x00) + raw


class _DynamicTable:
    """FIFO dynamic table with size accounting (RFC 7541 §4)."""

    def __init__(self, max_size: int = 4096):
        self.entries: List[Tuple[str, str]] = []  # newest first
        self.size = 0
        self.max_size = max_size

    @staticmethod
    def entry_size(name: str, value: str) -> int:
        return len(name.encode()) + len(value.encode()) + 32

    def add(self, name: str, value: str) -> None:
        need = self.entry_size(name, value)
        self.entries.insert(0, (name, value))
        self.size += need
        self._evict()
        if need > self.max_size:
            # entry larger than the table empties it (RFC 7541 §4.4)
            self.entries.clear()
            self.size = 0

    def resize(self, max_size: int) -> None:
        self.max_size = max_size
        self._evict()

    def _evict(self) -> None:
        while self.size > self.max_size and self.entries:
            n, v = self.entries.pop()
            self.size -= self.entry_size(n, v)

    def get(self, idx: int) -> Tuple[str, str]:
        """1-based index into the combined address space."""
        if 1 <= idx <= len(STATIC_TABLE):
            return STATIC_TABLE[idx - 1]
        didx = idx - len(STATIC_TABLE) - 1
        if 0 <= didx < len(self.entries):
            return self.entries[didx]
        raise HpackError(f"index {idx} out of table range")

    def find(self, name: str, value: str) -> Tuple[Optional[int], Optional[int]]:
        """(full-match index, name-match index), 1-based combined space."""
        full = _STATIC_FULL.get((name, value))
        name_only = _STATIC_NAME.get(name)
        if full is not None:
            return full, name_only
        for i, (n, v) in enumerate(self.entries):
            if n == name:
                idx = len(STATIC_TABLE) + i + 1
                if v == value:
                    return idx, idx
                if name_only is None:
                    name_only = idx
        return None, name_only


_CACHE_CAP = 512           # entry bound on the steady-state block caches
_CACHE_MAX_BLOCK = 2048    # don't cache oversized (peer-controlled) blocks
_CACHE_MAX_BYTES = 256 * 1024  # per-connection byte bound (decoder keys
                               # are peer-supplied: bound memory, not just
                               # entries)


class Decoder:
    def __init__(self, max_table_size: int = 4096):
        self._table = _DynamicTable(max_table_size)
        self._settings_max = max_table_size
        # steady-state fast path: an identical block decodes identically
        # as long as the dynamic table hasn't changed. Blocks that mutate
        # the table are never cached (and invalidate everything, since
        # dynamic indices shift); on the repeated header sets of a live
        # connection this skips parsing entirely.
        self._cache: dict = {}
        self._cache_bytes = 0

    def set_max_table_size(self, size: int) -> None:
        """Apply our SETTINGS_HEADER_TABLE_SIZE (the encoder must shrink
        to at most this via a dynamic-table-size-update)."""
        self._settings_max = size
        if size < self._table.max_size:
            self._table.resize(size)
        self._cache.clear()

    def decode(self, data: bytes) -> List[Tuple[str, str]]:
        cached = self._cache.get(data)
        if cached is not None:
            return list(cached)
        headers: List[Tuple[str, str]] = []
        mutated = False
        pos = 0
        while pos < len(data):
            b = data[pos]
            if b & 0x80:  # indexed field
                idx, pos = decode_int(data, pos, 7)
                if idx == 0:
                    raise HpackError("zero index")
                headers.append(self._table.get(idx))
            elif b & 0x40:  # literal with incremental indexing
                idx, pos = decode_int(data, pos, 6)
                name = (self._table.get(idx)[0] if idx
                        else None)
                if name is None:
                    name, pos = _decode_string(data, pos)
                value, pos = _decode_string(data, pos)
                self._table.add(name, value)
                mutated = True
                headers.append((name, value))
            elif b & 0x20:  # dynamic table size update
                size, pos = decode_int(data, pos, 5)
                if size > self._settings_max:
                    raise HpackError(
                        f"table size update {size} exceeds settings "
                        f"{self._settings_max}")
                self._table.resize(size)
                mutated = True
            else:  # literal without indexing (0x00) / never indexed (0x10)
                idx, pos = decode_int(data, pos, 4)
                name = self._table.get(idx)[0] if idx else None
                if name is None:
                    name, pos = _decode_string(data, pos)
                value, pos = _decode_string(data, pos)
                headers.append((name, value))
        if mutated:
            self._cache.clear()
            self._cache_bytes = 0
        elif len(data) <= _CACHE_MAX_BLOCK:
            if (len(self._cache) >= _CACHE_CAP
                    or self._cache_bytes >= _CACHE_MAX_BYTES):
                self._cache.clear()
                self._cache_bytes = 0
            self._cache[bytes(data)] = tuple(headers)
            self._cache_bytes += len(data)
        return headers


class Encoder:
    def __init__(self, max_table_size: int = 4096, huffman: bool = False):
        self._table = _DynamicTable(max_table_size)
        self.huffman = huffman
        self._pending_resize: Optional[int] = None
        # steady-state fast path (mirror of Decoder._cache): a header
        # list that encodes without inserting into the dynamic table
        # yields the same block until the table next changes
        self._cache: dict = {}

    def set_max_table_size(self, size: int) -> None:
        """Honor the peer's SETTINGS_HEADER_TABLE_SIZE: emit a size update
        in the next header block (RFC 7541 §6.3)."""
        size = min(size, 4096)
        self._pending_resize = size
        self._table.resize(size)
        self._cache.clear()

    _NEVER_INDEX = frozenset({"authorization", "cookie", "set-cookie"})

    def encode(self, headers: List[Tuple[str, str]]) -> bytes:
        key = tuple(headers)
        if self._pending_resize is None:
            cached = self._cache.get(key)
            if cached is not None:
                return cached
        out = bytearray()
        inserted = False
        if self._pending_resize is not None:
            out += encode_int(self._pending_resize, 5, 0x20)
            self._pending_resize = None
            inserted = True  # the size-update prefix must not be cached
        for name, value in headers:
            name = name.lower()
            full, name_idx = self._table.find(name, value)
            if full is not None:
                out += encode_int(full, 7, 0x80)
                continue
            if name in self._NEVER_INDEX:
                # sensitive: literal never-indexed (RFC 7541 §6.2.3)
                if name_idx is not None:
                    out += encode_int(name_idx, 4, 0x10)
                else:
                    out += encode_int(0, 4, 0x10)
                    out += _encode_string(name, self.huffman)
                out += _encode_string(value, self.huffman)
                continue
            # literal with incremental indexing
            if name_idx is not None:
                out += encode_int(name_idx, 6, 0x40)
            else:
                out += encode_int(0, 6, 0x40)
                out += _encode_string(name, self.huffman)
            out += _encode_string(value, self.huffman)
            self._table.add(name, value)
            inserted = True
        block = bytes(out)
        if inserted:
            # dynamic indices shifted: previously cached blocks are stale
            self._cache.clear()
        else:
            if len(self._cache) >= _CACHE_CAP:
                self._cache.clear()
            self._cache[key] = block
        return block
