"""A reader, in numpy alone, of the HDF5 files h5py writes with its default
(earliest) format: superblock version 0, version-1 object headers, groups
as symbol tables (a version-1 B-tree over symbol-table nodes, names in a
local heap), and datasets of fixed-size numbers with a contiguous or
compact layout.

The candidate databases (``cg_gates.h5``) are such files, and a machine
without h5py still reads them: ``read_group`` is all the explore layer
needs. Anything outside that format (chunked or compressed data, newer
object headers, string or compound types) raises ValueError.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

_SIGNATURE = b"\x89HDF\r\n\x1a\n"
_UNDEFINED = 0xFFFFFFFFFFFFFFFF


class _File:
    def __init__(self, data: bytes):
        if data[:8] != _SIGNATURE:
            raise ValueError("not an HDF5 file")
        if data[8] != 0:
            raise ValueError(f"superblock version {data[8]} (only version 0 is read)")
        self.data = data
        self.so, self.sl = data[13], data[14]  # sizes of offsets and lengths
        # four addresses of the superblock, then the root group's
        # symbol-table entry
        self.root_entry = 24 + 4 * self.so

    def uint(self, pos: int, size: int) -> int:
        return int.from_bytes(self.data[pos : pos + size], "little")

    def entry(self, pos: int) -> Tuple[int, int]:
        """A symbol-table entry's (name offset, object header address)."""
        return self.uint(pos, self.so), self.uint(pos + self.so, self.so)

    def entry_size(self) -> int:
        return 2 * self.so + 8 + 16  # then the cache type, reserved, the scratch pad

    def messages(self, addr: int) -> List[Tuple[int, int]]:
        """(type, position of its data) of every message of the version-1
        object header at ``addr``, continuation blocks followed."""
        if self.data[addr] != 1:
            raise ValueError(f"object header version {self.data[addr]} (only version 1 is read)")
        n = self.uint(addr + 2, 2)
        blocks = [(addr + 16, self.uint(addr + 8, 4))]
        out: List[Tuple[int, int]] = []
        while blocks and len(out) < n:
            pos, length = blocks.pop(0)
            end = pos + length
            while pos + 8 <= end and len(out) < n:
                mtype, msize = self.uint(pos, 2), self.uint(pos + 2, 2)
                out.append((mtype, pos + 8))
                if mtype == 0x10:  # continuation: another block of messages
                    blocks.append((self.uint(pos + 8, self.so), self.uint(pos + 8 + self.so, self.sl)))
                pos += 8 + msize
        return out

    def heap_name(self, heap: int, offset: int) -> str:
        if self.data[heap : heap + 4] != b"HEAP":
            raise ValueError("bad local heap")
        seg = self.uint(heap + 8 + 2 * self.sl, self.so)
        start = seg + offset
        return self.data[start : self.data.index(b"\0", start)].decode()

    def group_entries(self, btree: int, heap: int) -> Dict[str, int]:
        """{name: object header address} of a symbol-table group."""
        out: Dict[str, int] = {}
        if self.data[btree : btree + 4] != b"TREE" or self.data[btree + 4] != 0:
            raise ValueError("bad group B-tree node")
        level, used = self.data[btree + 5], self.uint(btree + 6, 2)
        pos = btree + 8 + 2 * self.so + self.sl  # past the siblings and key 0
        for _ in range(used):
            child = self.uint(pos, self.so)
            if level > 0:
                out.update(self.group_entries(child, heap))
            else:
                if self.data[child : child + 4] != b"SNOD":
                    raise ValueError("bad symbol-table node")
                for i in range(self.uint(child + 6, 2)):
                    name, header = self.entry(child + 8 + i * self.entry_size())
                    out[self.heap_name(heap, name)] = header
            pos += self.so + self.sl
        return out

    def children(self, addr: int) -> Dict[str, int]:
        """{name: address} of the group whose object header is at ``addr``;
        ValueError if it is no group."""
        for mtype, pos in self.messages(addr):
            if mtype == 0x11:  # symbol table: B-tree and local heap
                return self.group_entries(self.uint(pos, self.so), self.uint(pos + self.so, self.so))
        raise ValueError("not a group")

    def dataset(self, addr: int) -> np.ndarray:
        shape = dtype = raw = None
        for mtype, pos in self.messages(addr):
            if mtype == 0x01:  # dataspace
                version, rank = self.data[pos], self.data[pos + 1]
                first = pos + (8 if version == 1 else 4)
                shape = tuple(self.uint(first + i * self.sl, self.sl) for i in range(rank))
            elif mtype == 0x03:  # datatype
                cls, size = self.data[pos] & 0x0F, self.uint(pos + 4, 4)
                big = self.data[pos + 1] & 1
                if cls == 1:
                    kind = "f"
                elif cls == 0:
                    kind = "i" if self.data[pos + 1] & 0x08 else "u"
                else:
                    raise ValueError(f"datatype class {cls} (only fixed-size numbers are read)")
                dtype = np.dtype(f"{'>' if big else '<'}{kind}{size}")
            elif mtype == 0x08:  # data layout
                version, cls = self.data[pos], self.data[pos + 1]
                if version != 3:
                    raise ValueError(f"layout message version {version}")
                if cls == 1:
                    raw = (self.uint(pos + 2, self.so), self.uint(pos + 2 + self.so, self.sl))
                elif cls == 0:
                    raw = (pos + 4, self.uint(pos + 2, 2))
                else:
                    raise ValueError("chunked datasets are not read")
        if shape is None or dtype is None or raw is None:
            raise ValueError("not a dataset")
        start, nbytes = raw
        count = int(np.prod(shape)) if shape else 1
        if start == _UNDEFINED:  # never written: the fill value, zero by default
            return np.zeros(shape, dtype=dtype)
        if nbytes < count * dtype.itemsize:
            raise ValueError("dataset shorter than its shape")
        out = np.frombuffer(self.data, dtype=dtype, count=count, offset=start).reshape(shape)
        return out.astype(dtype.newbyteorder("="))  # native order, and a copy that owns its memory


def read_group(path, group: str) -> Dict[str, np.ndarray]:
    """{name: array} of every dataset in the top-level ``group`` of the file
    at ``path``, in name order; KeyError where the file has no such group,
    OSError where there is no file."""
    with open(path, "rb") as f:
        h = _File(f.read())
    _, root = h.entry(h.root_entry)
    top = h.children(root)
    if group not in top:
        raise KeyError(group)
    kids = h.children(top[group])
    return {name: h.dataset(kids[name]) for name in sorted(kids)}

