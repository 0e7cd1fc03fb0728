"""Atomic checkpoint save/restore (counterpart of
``nerf_fewshot_tpu/utils/checkpoint.py``).

The port's own format: ``torch.save`` of a dict of tensors and plain
values (the model state and the optimizer state), written through a temp
file and an atomic rename, plus a JSON sidecar ``<path>.json`` with the
scalar metadata. Restore reads it back with ``torch.load(weights_only=True)``,
which unpickles tensors and plain containers only. The JAX package's flax
msgpack checkpoints are a different format and are not read here.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, Optional, Tuple

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


def restore_checkpoint(
    path: str, map_location: Optional[torch.device] = None
) -> Tuple[Dict[str, Any], Optional[Dict]]:
    """Read a checkpoint written by :func:`save_checkpoint`; returns
    ``(tree, metadata or None)``."""
    tree = torch.load(path, map_location=map_location, weights_only=True)
    meta = None
    if os.path.exists(path + ".json"):
        with open(path + ".json") as f:
            meta = json.load(f)
    return tree, meta
