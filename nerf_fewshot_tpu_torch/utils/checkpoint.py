"""Atomic checkpoint save/restore (counterpart of
``nerf_fewshot_tpu/utils/checkpoint.py``).

The port's own format: ``torch.save`` of a dict of tensors and plain
values (the model state and the optimizer state), written through a temp
file and an atomic rename, plus a JSON sidecar ``<path>.json`` with the
scalar metadata. Restore reads it back with ``torch.load(weights_only=True)``,
which unpickles tensors and plain containers only.

The JAX package's checkpoints (``flax.serialization.to_bytes`` of the
train state, also named ``.ckpt``, with the same JSON sidecar) are read by
``read_msgpack`` / ``restore_msgpack_checkpoint`` in pure Python and numpy:
neither flax nor msgpack is needed. ``checkpoint_format`` tells the two
apart by their first bytes.
"""

from __future__ import annotations

import json
import os
import struct
import tempfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


def _atomic_write(path: str, write, mode: str) -> None:
    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, mode) as f:
            write(f)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def save_checkpoint(path: str, tree: Dict[str, Any], metadata: Optional[Dict] = None) -> None:
    """Write ``tree`` to ``path`` atomically; metadata -> ``path.json``."""
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    _atomic_write(path, lambda f: torch.save(tree, f), "wb")
    if metadata is not None:
        _atomic_write(path + ".json",
                      lambda f: json.dump(metadata, f, indent=2, default=str), "w")


def _read_sidecar(path: str) -> Optional[Dict]:
    if not os.path.exists(path + ".json"):
        return None
    with open(path + ".json") as f:
        return json.load(f)


def restore_checkpoint(
    path: str, map_location: Optional[torch.device] = None
) -> Tuple[Dict[str, Any], Optional[Dict]]:
    """Read a checkpoint written by :func:`save_checkpoint`; returns
    ``(tree, metadata or None)``."""
    return torch.load(path, map_location=map_location, weights_only=True), _read_sidecar(path)


def checkpoint_format(path: str) -> str:
    """``"torch"`` for a ``torch.save`` zip (``PK\\x03\\x04``), ``"msgpack"``
    for a flax msgpack map (a first byte of 0x80-0x8f, 0xde or 0xdf);
    raises for anything else."""
    with open(path, "rb") as f:
        head = f.read(4)
    if head == b"PK\x03\x04":
        return "torch"
    if head and (0x80 <= head[0] <= 0x8F or head[0] in (0xDE, 0xDF)):
        return "msgpack"
    raise ValueError(f"{path}: neither a torch.save zip nor a flax msgpack checkpoint "
                     f"(first bytes {head!r})")


# msgpack ext types of flax.serialization
_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"


class _MsgpackReader:
    """Decoder of the msgpack subset ``flax.serialization.to_bytes``
    writes: maps, arrays (as lists), str, bin, ints, floats, nil, bools and
    flax's ext types."""

    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError(f"msgpack: truncated at byte {self.pos} (need {n} more)")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}  # bin 8/16/32
        if b in sized:
            return bytes(self.take(self.unpack(sized[b])))
        if b in (0xC7, 0xC8, 0xC9):  # ext 8/16/32
            n = self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])
            return self.ext(self.unpack(">b"), n)
        if 0xD4 <= b <= 0xD8:  # fixext 1/2/4/8/16
            return self.ext(self.unpack(">b"), 1 << (b - 0xD4))
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                   0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        if b in (0xD9, 0xDA, 0xDB):  # str 8/16/32
            return self.str(self.unpack({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[b]))
        if b in (0xDC, 0xDD):  # array 16/32
            return [self.value() for _ in range(self.unpack(">H" if b == 0xDC else ">I"))]
        if b in (0xDE, 0xDF):  # map 16/32
            return self.map(self.unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"msgpack: byte 0x{b:02x} at {self.pos - 1} starts no value")

    def str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def map(self, n: int) -> Dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        if _CHUNKED in out:
            raise ValueError("msgpack: a chunked array leaf (an array over 2^30 bytes) is not "
                             "supported")
        return out

    def ext(self, code: int, n: int) -> Any:
        payload = bytes(self.take(n))
        if code in (_EXT_NDARRAY, _EXT_NPSCALAR):
            shape, dtype, buf = read_msgpack(payload)
            dtype = dtype.decode() if isinstance(dtype, bytes) else dtype
            if dtype == "bfloat16":
                raise ValueError("msgpack: bfloat16 arrays need ml_dtypes, which the port "
                                 "does not use")
            arr = np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape, order="C")
            return arr if code == _EXT_NDARRAY else arr[()]
        if code == _EXT_COMPLEX:
            re, im = read_msgpack(payload)
            return complex(re, im)
        raise ValueError(f"msgpack: ext type {code} is not one flax writes")


def read_msgpack(data: bytes) -> Any:
    """Decode one msgpack value as ``flax.serialization.msgpack_restore``
    does: maps -> dicts (list-like nodes stay the ``"0"``, ``"1"``, ...
    keyed dicts flax writes), arrays -> lists, ext 1 -> read-only
    ``np.ndarray`` of the stored dtype and shape, ext 3 -> numpy scalar,
    ext 2 -> complex. Raises on chunked array leaves, on unknown ext types
    and on bytes after the value."""
    reader = _MsgpackReader(data)
    out = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError(f"msgpack: {len(reader.data) - reader.pos} bytes after the value")
    return out


def restore_msgpack_checkpoint(path: str) -> Tuple[Dict[str, Any], Optional[Dict]]:
    """Read a JAX package checkpoint: ``(tree, metadata or None)``, the tree
    with numpy leaves."""
    with open(path, "rb") as f:
        return read_msgpack(f.read()), _read_sidecar(path)
