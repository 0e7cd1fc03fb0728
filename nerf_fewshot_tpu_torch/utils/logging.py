"""Structured training logs and PNG image dumps (counterpart of
``nerf_fewshot_tpu/utils/logging.py``).

A JSONL sink (one dict per line), or a CSV sink when the log path ends in
``.csv`` (the header from the first record's sorted keys, one row per
record, numbers as floats, keys the header lacks left out), mirrored to
a wandb run under ``use_wandb`` when the ``wandb`` package imports and its
run starts (else the file sink alone, as in the JAX package). PNGs are
written with ``zlib`` and ``struct`` from the standard library: the card
machine has no PIL.
"""

from __future__ import annotations

import csv
import json
import os
import struct
import time
import zlib
from typing import Any, Dict, Optional

import numpy as np


class JSONLLogger:
    def __init__(self, path: Optional[str] = None, use_wandb: bool = False,
                 wandb_project: str = "nerf-fewshot-tpu", run_name: str = "run",
                 config: Optional[Dict] = None):
        self.path = path
        self._fh = None
        self._csv = None
        self._csv_fields: Optional[list] = None
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
            is_csv = path.endswith(".csv")
            self._fh = open(path, "a", newline="" if is_csv else None)
            if is_csv:
                self._csv = csv.writer(self._fh)
        self._wandb = None
        if use_wandb:
            try:
                import wandb

                self._wandb = wandb.init(project=wandb_project, name=run_name,
                                         config=config or {})
            except Exception:  # no package or no credentials: the file sink alone
                self._wandb = None

    def log(self, record: Dict[str, Any]) -> None:
        record = dict(record)
        record.setdefault("time", time.time())
        if self._csv is not None:
            if self._csv_fields is None:
                self._csv_fields = sorted(record)
                self._csv.writerow(self._csv_fields)
            self._csv.writerow(
                [float(record[k]) if isinstance(record.get(k), (int, float))
                 else record.get(k, "") for k in self._csv_fields])
            self._fh.flush()
        elif self._fh:
            self._fh.write(json.dumps(record, default=float) + "\n")
            self._fh.flush()
        if self._wandb is not None:
            self._wandb.log({k: v for k, v in record.items() if k != "time"})

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None
            self._csv = None
        if self._wandb is not None:
            self._wandb.finish()
            self._wandb = None


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def save_png(path: str, image: np.ndarray) -> None:
    """Save an (H, W, 3) float [0, 1] image as an 8-bit RGB PNG (pixels
    ``uint8(clip(255 * x, 0, 255))``, as the JAX package writes them)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    arr = np.clip(np.asarray(image) * 255.0, 0, 255).astype(np.uint8)
    if arr.ndim != 3 or arr.shape[2] != 3:
        raise ValueError(f"save_png: expected an (H, W, 3) image, got {arr.shape}")
    H, W, _ = arr.shape
    rows = b"".join(b"\x00" + arr[y].tobytes() for y in range(H))  # filter 0 per row
    png = (b"\x89PNG\r\n\x1a\n"
           + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 2, 0, 0, 0))
           + _png_chunk(b"IDAT", zlib.compress(rows))
           + _png_chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)
