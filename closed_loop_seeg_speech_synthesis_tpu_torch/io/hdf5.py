"""HDF5 files without h5py: the subset of the format this system's files use.

The port's one path for HDF5 (recordings, ``params.h5``, a decode run's
``sEEG.hdf``), in numpy, ``struct`` and ``zlib``.  The API is the part of
h5py's that the call sites use: ``File(path, "r"|"w")`` as a context
manager, ``create_dataset(name, data=, dtype=)``, ``__getitem__``,
``__contains__`` and ``keys()``; a dataset has ``.shape``, ``.dtype``,
``[...]``, ``[()]`` and leading-axis slices (``[:n]``, ``[a:b]``), which
read only those rows from disk.

Writer (``"w"``): the layout h5py writes by default (HDF5 1.14,
``libver="earliest"``): superblock version 0, version-1 object headers, a
symbol-table root group whose one leaf node holds every link (the group leaf
K is raised to fit them), per dataset the dataspace (version 1), datatype,
fill value (version 2) and layout (version 3) messages, contiguous data, and
the undefined address for an empty dataset.  Types: little- or big-endian
integers and floats (``<f8 <f4 <i8 <i4 <i2 u1`` and the like), bool as
h5py's enum (int8, FALSE = 0, TRUE = 1), ``np.void`` as opaque, fixed-length
``S`` strings; scalar and N-d shapes.

Reader (``"r"``): superblock versions 0 and 1, version-1 object headers with
continuation messages, symbol-table groups of any size (the group B-tree
walked through its internal nodes), compact, contiguous and chunked layouts
(a version-1 chunk B-tree, with the deflate and shuffle filters), the types
above in either byte order.  Anything else raises ``NotImplementedError``
naming the feature: superblock versions 2 and 3 (``libver="latest"``),
version-2 object headers, compact or dense link storage, variable-length,
compound and the other datatype classes, other filters, external storage.
"""

from __future__ import annotations

import math
import os
import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89HDF\r\n\x1a\n"
_OFFSET = 8  # the writer's size of offsets and lengths, as h5py's
_SUPERBLOCK_V0 = 24 + 4 * _OFFSET + 2 * _OFFSET + 8 + 16  # 96 bytes
_UNDEFINED = 0xFFFFFFFFFFFFFFFF
_GROUP_INTERNAL_K = 16  # HDF5's default; the writer's one B-tree node has 2K slots
_GROUP_LEAF_K = 4  # HDF5's default, raised so that one leaf node holds every link
_HEAP_FREE_NULL = 1  # a local heap's "no free block" offset (H5HL_FREE_NULL)

# object header message types
_NIL, _DATASPACE, _LINK_INFO, _DATATYPE, _FILL_OLD, _FILL = 0x0, 0x1, 0x2, 0x3, 0x4, 0x5
_LINK, _EXTERNAL, _LAYOUT, _GROUP_INFO, _FILTERS = 0x6, 0x7, 0x8, 0xA, 0xB
_CONTINUATION, _SYMBOL_TABLE = 0x10, 0x11
# messages that carry nothing a dataset's values or a group's links depend on
_IGNORED = {_NIL, _FILL_OLD, _FILL, 0x9, 0xC, 0xD, 0xE, 0xF, 0x12, 0x13, 0x14, 0x15, 0x16,
            0x17, 0x18}

_CLASS_NAMES = {0: "fixed-point", 1: "floating-point", 2: "time", 3: "string", 4: "bitfield",
                5: "opaque", 6: "compound", 7: "reference", 8: "enum", 9: "variable-length",
                10: "array"}
_FILTER_NAMES = {1: "deflate", 2: "shuffle", 3: "fletcher32", 4: "szip", 5: "nbit",
                 6: "scaleoffset", 307: "bzip2", 32000: "lzf", 32001: "blosc", 32004: "lz4",
                 32015: "zstd"}
# IEEE layouts by size: (exponent location, exponent size, mantissa size, bias)
_IEEE = {2: (10, 5, 10, 15), 4: (23, 8, 23, 127), 8: (52, 11, 52, 1023)}
_BOOL_MEMBERS = {b"FALSE": 0, b"TRUE": 1}


def _uint(buf, pos, n):
    return int.from_bytes(buf[pos : pos + n], "little")


def _pad8(n):
    return -(-n // 8) * 8


# ---------------------------------------------------------------- reading


class _Reader:
    """The open file and its superblock's sizes; addresses are relative to
    the base address."""

    def __init__(self, path):
        self.path = os.fspath(path)
        self.fh = open(self.path, "rb")
        try:
            self._superblock()
        except BaseException:
            self.fh.close()
            raise

    def _superblock(self):
        head = self.fh.read(9)
        if head[:8] != _SIGNATURE:
            raise OSError(f"{self.path}: not an HDF5 file (no signature at byte 0; a user "
                          "block is not read)")
        version = head[8]
        if version in (2, 3):
            raise NotImplementedError(
                f"{self.path}: HDF5 superblock version {version} (libver='latest' or 'v108' and "
                "newer) is not read; write the file with h5py's default libver='earliest'")
        if version not in (0, 1):
            raise NotImplementedError(f"{self.path}: HDF5 superblock version {version}")
        sb = self.read(0, 24 + (4 if version == 1 else 0) + 4 * 8 + 40, absolute=True)
        self.so, self.sl = sb[13], sb[14]
        if self.so not in (2, 4, 8) or self.sl not in (2, 4, 8):
            raise OSError(f"{self.path}: corrupt superblock (offset size {self.so})")
        self.undefined = (1 << (8 * self.so)) - 1
        pos = 24 + (4 if version == 1 else 0)
        self.base = _uint(sb, pos, self.so)
        pos += 4 * self.so  # the four addresses before the root group's entry
        sb = self.read(0, pos + 2 * self.so + 8 + 16, absolute=True)
        # the root group's symbol table entry: name offset, object header address
        self.root = _uint(sb, pos + self.so, self.so)

    def read(self, addr, n, absolute=False):
        self.fh.seek(addr if absolute else self.base + addr)
        buf = self.fh.read(n)
        if len(buf) != n:
            raise OSError(f"{self.path}: truncated HDF5 file (read of {n} bytes at {addr})")
        return buf

    def messages(self, addr):
        """(type, data) of every message of the object header at ``addr``,
        continuation blocks included."""
        prefix = self.read(addr, 16)
        if prefix[:4] == b"OHDR":
            raise NotImplementedError(f"{self.path}: HDF5 version 2 object headers (libver="
                                      "'latest' or 'v108' and newer) are not read")
        if prefix[0] != 1:
            raise NotImplementedError(f"{self.path}: HDF5 object header version {prefix[0]}")
        n_messages = struct.unpack_from("<H", prefix, 2)[0]
        blocks = [(addr + 16, struct.unpack_from("<I", prefix, 8)[0])]
        out = []
        while blocks and len(out) < n_messages:
            start, size = blocks.pop(0)
            buf = self.read(start, size)
            pos = 0
            while pos + 8 <= size and len(out) < n_messages:
                mtype, msize, flags = struct.unpack_from("<HHB", buf, pos)
                data = buf[pos + 8 : pos + 8 + msize]
                pos += 8 + msize
                if flags & 0x02:
                    raise NotImplementedError(f"{self.path}: shared HDF5 object header messages "
                                              f"(type {mtype:#x})")
                if mtype == _CONTINUATION:
                    blocks.append((_uint(data, 0, self.so), _uint(data, self.so, self.sl)))
                out.append((mtype, data))
        return out

    def object(self, addr, name):
        """The Group or Dataset whose object header is at ``addr``."""
        messages = self.messages(addr)
        types = {t for t, _ in messages}
        if _SYMBOL_TABLE in types:
            data = next(d for t, d in messages if t == _SYMBOL_TABLE)
            return Group(self, name, _uint(data, 0, self.so), _uint(data, self.so, self.so))
        if _LINK_INFO in types or _LINK in types or _GROUP_INFO in types:
            dense = any(t == _LINK_INFO and _uint(d, 2 + (8 if d[1] & 1 else 0), self.so)
                        != self.undefined for t, d in messages)
            raise NotImplementedError(
                f"{self.path}:{name}: HDF5 groups with "
                f"{'dense' if dense else 'compact'} link storage (new-style groups) are not read")
        if _LAYOUT in types:
            return Dataset(self, name, messages)
        raise NotImplementedError(f"{self.path}:{name}: HDF5 object of unknown kind "
                                  f"(messages {sorted(types)})")

    def links(self, btree, heap):
        """{name: object header address (None for a soft link)} of a
        symbol-table group."""
        head = self.read(heap, 8 + 2 * self.sl + self.so)
        if head[:4] != b"HEAP":
            raise OSError(f"{self.path}: corrupt HDF5 local heap at {heap}")
        size = _uint(head, 8, self.sl)
        names = self.read(_uint(head, 8 + 2 * self.sl, self.so), size)
        out = {}
        for snod in self._group_leaves(btree):
            head = self.read(snod, 8)
            if head[:4] != b"SNOD":
                raise OSError(f"{self.path}: corrupt HDF5 symbol table node at {snod}")
            n = struct.unpack_from("<H", head, 6)[0]
            entry = 2 * self.so + 8 + 16
            buf = self.read(snod + 8, n * entry)
            for i in range(n):
                off = _uint(buf, i * entry, self.so)
                name = names[off : names.index(b"\0", off)].decode("utf-8")
                soft = struct.unpack_from("<I", buf, i * entry + 2 * self.so)[0] == 2
                out[name] = None if soft else _uint(buf, i * entry + self.so, self.so)
        return out

    def _btree(self, addr, node_type, key_size):
        """(level, [(key bytes, child address), ...]) of a version-1 B-tree
        node; the keys are each child's left key."""
        head = self.read(addr, 8 + 2 * self.so)
        if head[:4] != b"TREE" or head[4] != node_type:
            raise OSError(f"{self.path}: corrupt HDF5 B-tree node at {addr}")
        level, used = head[5], struct.unpack_from("<H", head, 6)[0]
        stride = key_size + self.so
        buf = self.read(addr + 8 + 2 * self.so, used * stride + key_size)
        return level, [(buf[i * stride : i * stride + key_size],
                        _uint(buf, i * stride + key_size, self.so)) for i in range(used)]

    def _group_leaves(self, addr):
        level, entries = self._btree(addr, 0, self.sl)
        for _, child in entries:
            if level:
                yield from self._group_leaves(child)
            else:
                yield child

    def chunks(self, addr, rank):
        """(offsets, stored size, filter mask, address) of every chunk under
        the version-1 chunk B-tree at ``addr``."""
        key_size = 8 + 8 * (rank + 1)
        level, entries = self._btree(addr, 1, key_size)
        for key, child in entries:
            if level:
                yield from self.chunks(child, rank)
            else:
                size, mask = struct.unpack_from("<II", key, 0)
                yield struct.unpack_from(f"<{rank}Q", key, 8), size, mask, child


def _dtype(buf, pos, where):
    """(numpy dtype, end position) of the datatype message at ``buf[pos:]``."""
    cls, version = buf[pos] & 0x0F, buf[pos] >> 4
    bits = _uint(buf, pos + 1, 3)
    size = struct.unpack_from("<I", buf, pos + 4)[0]
    props = pos + 8
    order = ">" if bits & 1 else "<"
    if cls == 0:
        offset, precision = struct.unpack_from("<HH", buf, props)
        if offset or precision != 8 * size or size not in (1, 2, 4, 8):
            raise NotImplementedError(f"{where}: HDF5 integer of {precision} bits at offset "
                                      f"{offset} in {size} bytes")
        return np.dtype(f"{order}{'i' if bits & 0x08 else 'u'}{size}"), props + 4
    if cls == 1:
        layout = struct.unpack_from("<HHBBBBI", buf, props)
        ieee = _IEEE.get(size)
        if (bits & 0x40 or ieee is None or layout[:2] != (0, 8 * size) or (bits >> 8) & 0xFF
                != 8 * size - 1 or (layout[2], layout[3], layout[5], layout[6])
                != ieee or layout[4] != 0):
            raise NotImplementedError(f"{where}: HDF5 floating-point type other than IEEE "
                                      f"binary16/32/64 ({size} bytes, layout {layout})")
        return np.dtype(f"{order}f{size}"), props + 12
    if cls == 3:
        return np.dtype(f"S{size}"), props
    if cls == 5:
        return np.dtype(f"V{size}"), props + (bits & 0xFF)
    if cls == 8:
        base, end = _dtype(buf, props, where)
        names = []
        for _ in range(bits & 0xFFFF):
            stop = buf.index(b"\0", end)
            names.append(bytes(buf[end:stop]))
            end = stop + 1 if version >= 3 else end + _pad8(stop + 1 - end)
        values = np.frombuffer(buf, base, len(names), end)
        end += base.itemsize * len(names)
        if base.kind in "iu" and base.itemsize == 1 and dict(zip(names, values.tolist())) \
                == _BOOL_MEMBERS:
            return np.dtype(bool), end
        return base, end
    if cls == 9:
        raise NotImplementedError(f"{where}: HDF5 variable-length datatypes (vlen strings and "
                                  "sequences) are not read")
    raise NotImplementedError(f"{where}: HDF5 {_CLASS_NAMES.get(cls, cls)} datatype is not read")


def _unshuffle(raw, itemsize):
    n = len(raw) // itemsize
    body = np.frombuffer(raw, np.uint8, n * itemsize).reshape(itemsize, n).T.tobytes()
    return body + raw[n * itemsize :]


class Dataset:
    """A dataset of an open file: ``shape``, ``dtype``; ``[...]`` / ``[()]``
    read it all, ``[a:b]`` rows ``a:b`` of its leading axis only."""

    def __init__(self, reader, name, messages):
        self._r, self.name = reader, name
        self._filters, self._fill = [], None
        where = f"{reader.path}:{name}"
        for mtype, data in messages:
            if mtype == _DATASPACE:
                self.shape = self._dataspace(data, where)
            elif mtype == _DATATYPE:
                self.dtype = _dtype(data, 0, where)[0]
            elif mtype == _LAYOUT:
                self._layout = self._parse_layout(data, where)
            elif mtype == _FILTERS:
                self._filters = self._parse_filters(data, where)
            elif mtype == _FILL and data[0] in (1, 2) and data[3]:
                size = struct.unpack_from("<I", data, 4)[0]
                self._fill = bytes(data[8 : 8 + size]) or None
            elif mtype == _EXTERNAL:
                raise NotImplementedError(f"{where}: HDF5 external data storage is not read")
            elif mtype not in _IGNORED and mtype != _CONTINUATION:
                raise NotImplementedError(f"{where}: HDF5 object header message type {mtype:#x}")

    def _dataspace(self, data, where):
        version, rank = data[0], data[1]
        if version == 1:
            pos = 8
        elif version == 2:
            if data[3] == 2:
                raise NotImplementedError(f"{where}: HDF5 null dataspace is not read")
            pos = 4
        else:
            raise NotImplementedError(f"{where}: HDF5 dataspace message version {version}")
        return tuple(_uint(data, pos + i * self._r.sl, self._r.sl) for i in range(rank))

    def _parse_layout(self, data, where):
        if data[0] != 3:
            raise NotImplementedError(f"{where}: HDF5 data layout message version {data[0]}")
        so = self._r.so
        if data[1] == 0:
            size = struct.unpack_from("<H", data, 2)[0]
            return "compact", bytes(data[4 : 4 + size])
        if data[1] == 1:
            return "contiguous", _uint(data, 2, so)
        if data[1] == 2:
            dims = struct.unpack_from(f"<{data[2]}I", data, 3 + so)
            return "chunked", (_uint(data, 3, so), dims[:-1])
        raise NotImplementedError(f"{where}: HDF5 data layout class {data[1]}")

    @staticmethod
    def _parse_filters(data, where):
        version, count = data[0], data[1]
        pos = 8 if version == 1 else 2
        out = []
        for _ in range(count):
            fid = struct.unpack_from("<H", data, pos)[0]
            pos += 2
            name_len = 0
            if version == 1 or fid >= 256:
                name_len = struct.unpack_from("<H", data, pos)[0]
                pos += 2
            _, n_values = struct.unpack_from("<HH", data, pos)
            pos += 4 + (_pad8(name_len) if version == 1 else name_len)
            values = struct.unpack_from(f"<{n_values}I", data, pos)
            pos += 4 * n_values + (4 if version == 1 and n_values % 2 else 0)
            if fid not in (1, 2):
                raise NotImplementedError(f"{where}: HDF5 filter {_FILTER_NAMES.get(fid, 'unknown')}"
                                          f" (id {fid}) is not read; deflate and shuffle are")
            out.append((fid, values))
        return out

    @property
    def ndim(self):
        return len(self.shape)

    def __array__(self, dtype=None, copy=None):
        out = self[...]
        return out if dtype is None else out.astype(dtype)

    def __getitem__(self, key):
        if key is Ellipsis or key == ():
            out = self._rows(0, self.shape[0] if self.shape else None)
            return out[()] if key == () else out
        if not isinstance(key, slice) or not self.shape or key.step not in (None, 1):
            raise TypeError(f"{self.name}: index {key!r}; this reader takes [...], [()] and a "
                            "slice a:b of a dataset's leading axis")
        start, stop, _ = key.indices(self.shape[0])
        return self._rows(start, max(start, stop))

    def _fill_array(self, shape):
        fill = np.frombuffer(self._fill, self.dtype)[0] if self._fill else 0
        return np.full(shape, fill, self.dtype)

    def _rows(self, a, b):
        """Rows a:b of the leading axis (the whole scalar when b is None)."""
        shape = self.shape if b is None else (b - a,) + self.shape[1:]
        count = math.prod(shape)
        kind, value = self._layout
        if count == 0:
            return np.zeros(shape, self.dtype)
        row = math.prod(self.shape[1:]) * self.dtype.itemsize
        if kind == "compact":
            return np.frombuffer(value, self.dtype, count, a * row).reshape(shape).copy()
        if kind == "contiguous":
            if value == self._r.undefined:
                return self._fill_array(shape)
            return np.fromfile(self._r.path, dtype=self.dtype, count=count,
                               offset=self._r.base + value + a * row).reshape(shape)
        return self._chunked(a, shape, *value)

    def _chunked(self, a, shape, btree, cshape):
        out = self._fill_array(shape)
        if btree == self._r.undefined:
            return out
        b = a + shape[0]
        itemsize = self.dtype.itemsize
        for offsets, size, mask, addr in self._r.chunks(btree, self.ndim):
            r0 = offsets[0]
            if r0 >= b or r0 + cshape[0] <= a:
                continue
            raw = self._r.read(addr, size)
            for i in reversed(range(len(self._filters))):
                if mask >> i & 1:
                    continue
                fid, values = self._filters[i]
                raw = zlib.decompress(raw) if fid == 1 else _unshuffle(raw, values[0] if values
                                                                       else itemsize)
            if len(raw) != math.prod(cshape) * itemsize:
                raise OSError(f"{self._r.path}:{self.name}: corrupt chunk at {offsets}")
            chunk = np.frombuffer(raw, self.dtype).reshape(cshape)
            lo, hi = max(a, r0), min(b, r0 + cshape[0])
            src = [slice(lo - r0, hi - r0)]
            dst = [slice(lo - a, hi - a)]
            for off, c, n in zip(offsets[1:], cshape[1:], self.shape[1:]):
                src.append(slice(0, min(c, n - off)))
                dst.append(slice(off, off + min(c, n - off)))
            out[tuple(dst)] = chunk[tuple(src)]
        return out


class Group:
    """A symbol-table group: ``keys()``, ``[name]``, ``name in group``."""

    def __init__(self, reader, name, btree, heap):
        self._r, self.name = reader, name
        self._links = reader.links(btree, heap)

    def keys(self):
        return list(self._links)

    def __iter__(self):
        return iter(self._links)

    def __len__(self):
        return len(self._links)

    def __contains__(self, name):
        return name in self._links

    def __getitem__(self, name):
        if name not in self._links:
            raise KeyError(f"{name!r} is not in HDF5 group {self.name!r} of {self._r.path}")
        path = f"{self.name.rstrip('/')}/{name}"
        if self._links[name] is None:
            raise NotImplementedError(f"{self._r.path}:{path}: HDF5 soft links are not read")
        return self._r.object(self._links[name], path)


# ---------------------------------------------------------------- writing


def _message(mtype, data, flags=0):
    data = data + b"\0" * (_pad8(len(data)) - len(data))
    return struct.pack("<HHB3x", mtype, len(data), flags) + data


def _datatype_message(dt):
    order = 1 if dt.str[0] == ">" else 0
    if dt.kind == "b":
        base = struct.pack("<B3sI", 0x10, bytes([0x08, 0, 0]), 1) + struct.pack("<HH", 0, 8)
        names = b"FALSE\0\0\0" + b"TRUE\0\0\0\0"
        return struct.pack("<B3sI", 0x18, (2).to_bytes(3, "little"), 1) + base + names + b"\0\1"
    if dt.kind in "iu" and dt.itemsize in (1, 2, 4, 8):
        bits = order | (0x08 if dt.kind == "i" else 0)
        return struct.pack("<B3sIHH", 0x10, bytes([bits, 0, 0]), dt.itemsize, 0, 8 * dt.itemsize)
    if dt.kind == "f" and dt.itemsize in _IEEE:
        eloc, esize, msize, bias = _IEEE[dt.itemsize]
        return struct.pack("<B3sIHHBBBBI", 0x11, bytes([order | 0x20, 8 * dt.itemsize - 1, 0]),
                           dt.itemsize, 0, 8 * dt.itemsize, eloc, esize, 0, msize, bias)
    if dt.kind == "S":
        return struct.pack("<B3sI", 0x13, bytes([0x01, 0, 0]), dt.itemsize)  # null-padded ASCII
    if dt.kind == "V" and dt.names is None and dt.subdtype is None:
        return struct.pack("<B3sI", 0x15, bytes(3), dt.itemsize)  # opaque, no tag
    raise TypeError(f"no HDF5 datatype for {dt} in this writer (it writes integers, IEEE floats, "
                    "bool, fixed-length bytes and np.void)")


def _dataset_header(shape, dt, addr, nbytes):
    rank = len(shape)
    space = struct.pack("<BBBx4x", 1, rank, 1 if rank else 0)
    space += struct.pack(f"<{2 * rank}Q", *shape, *shape)
    fill = struct.pack("<BBBBI", 2, 2, 2, 1, 0)  # late allocation, fill if set, default value
    layout = struct.pack("<BBQQ", 3, 1, addr, nbytes)
    messages = (_message(_DATASPACE, space) + _message(_DATATYPE, _datatype_message(dt), 1)
                + _message(_FILL, fill, 1) + _message(_LAYOUT, layout))
    return struct.pack("<BBHII4x", 1, 0, 4, 1, len(messages)) + messages


class _Writer:
    """Appends each dataset's data as it is created and the metadata (the
    object headers, the root group's heap, symbol table node and B-tree,
    then the superblock) at close."""

    def __init__(self, path):
        self.path = os.fspath(path)
        self.fh = open(self.path, "wb")
        self.fh.write(b"\0" * _SUPERBLOCK_V0)
        self.datasets = {}

    def create_dataset(self, name, data, dtype):
        if not name or "/" in name:
            raise ValueError(f"dataset name {name!r}: this writer keeps datasets in the root group")
        if name in self.datasets:
            raise ValueError(f"unable to create dataset {name!r}: name already exists")
        arr = np.asarray(data, dtype=dtype)
        if arr.dtype.kind in "UOMm":
            raise TypeError(f"no HDF5 datatype for {arr.dtype} in this writer")
        _datatype_message(arr.dtype)
        arr = np.array(arr, order="C", copy=None)  # keeps a scalar's shape ()
        addr = _UNDEFINED
        if arr.nbytes:
            addr = self.fh.tell()
            self.fh.write(arr.reshape(-1).view(np.uint8))
        self.datasets[name] = (arr.shape, arr.dtype, addr, arr.nbytes)

    def close(self):
        fh = self.fh
        try:
            names = sorted(self.datasets, key=lambda n: n.encode("utf-8"))
            heap, offsets = bytearray(8), {}
            for name in names:
                offsets[name] = len(heap)
                raw = name.encode("utf-8") + b"\0"
                heap += raw + b"\0" * (_pad8(len(raw)) - len(raw))
            headers = {}
            for name in names:
                headers[name] = fh.tell()
                fh.write(_dataset_header(*self.datasets[name]))
            leaf_k = max(_GROUP_LEAF_K, -(-len(names) // 2))
            snod = fh.tell()
            entries = b"".join(struct.pack("<QQII16x", offsets[n], headers[n], 0, 0) for n in names)
            fh.write(struct.pack("<4sBBH", b"SNOD", 1, 0, len(names)) + entries
                     + b"\0" * (40 * 2 * leaf_k - len(entries)))
            btree = fh.tell()
            node = struct.pack("<4sBBHQQ", b"TREE", 0, 0, 1 if names else 0, _UNDEFINED, _UNDEFINED)
            if names:
                node += struct.pack("<QQQ", 0, snod, offsets[names[-1]])
            fh.write(node + b"\0" * (24 + (4 * _GROUP_INTERNAL_K + 1) * 8 - len(node)))
            heap_addr = fh.tell()
            fh.write(struct.pack("<4sB3xQQQ", b"HEAP", 0, len(heap), _HEAP_FREE_NULL,
                                 heap_addr + 32) + heap)
            root = fh.tell()
            table = _message(_SYMBOL_TABLE, struct.pack("<QQ", btree, heap_addr))
            fh.write(struct.pack("<BBHII4x", 1, 0, 1, 1, len(table)) + table)
            eof = fh.tell()
            fh.seek(0)
            fh.write(_SIGNATURE + struct.pack("<8BHHI", 0, 0, 0, 0, 0, _OFFSET, _OFFSET, 0,
                                              leaf_k, _GROUP_INTERNAL_K, 0)
                     + struct.pack("<QQQQ", 0, _UNDEFINED, eof, _UNDEFINED)
                     + struct.pack("<QQII", 0, root, 1, 0) + struct.pack("<QQ", btree, heap_addr))
        finally:
            fh.close()


class File:
    """An HDF5 file, ``"r"`` (read: ``keys()``, ``[name]``, ``name in file``)
    or ``"w"`` (create or truncate, and ``create_dataset`` into the root
    group; the metadata goes to disk at close)."""

    def __init__(self, path, mode="r"):
        self.filename, self.mode = os.fspath(path), mode
        self._w = self._r = self._root = None
        if mode == "w":
            self._w = _Writer(path)
        elif mode == "r":
            self._r = _Reader(path)
            try:
                self._root = self._r.object(self._r.root, "/")
            except BaseException:
                self._r.fh.close()
                raise
        else:
            raise ValueError(f"mode {mode!r}: this HDF5 codec opens files with 'r' or 'w'")

    def create_dataset(self, name, data=None, dtype=None):
        if self._w is None:
            raise ValueError(f"{self.filename} is not open for writing")
        if data is None:
            raise TypeError("create_dataset needs data=")
        self._w.create_dataset(name, data, dtype)

    def _group(self):
        if self._root is None:
            raise ValueError(f"{self.filename} is not open for reading")
        return self._root

    def keys(self):
        return self._group().keys()

    def __getitem__(self, name):
        return self._group()[name]

    def __contains__(self, name):
        return name in self._group()

    def __len__(self):
        return len(self._group())

    def close(self):
        if self._w is not None:
            w, self._w = self._w, None
            w.close()
        if self._r is not None:
            self._r.fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
