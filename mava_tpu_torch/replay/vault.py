"""Vault: replay trajectories kept on disk for offline MARL (port of
`mava_tpu/replay/vault.py`, the stand-in for flashbax's `Vault`).

The format is the reference's, so that a vault written by either package reads
back in the other: one directory `<cwd>/<rel_dir>/<vault_name>/<uid>` holding
`manifest.json` (`{"chunk_count": n, "paths": [leaf names]}`), `treedef.txt`
and one directory `chunk_<i:06d>` a `write`, with one `.npy` file a leaf.
`write` appends a slab of trajectories (leaves (batch, time, ...)) along the
time axis; `read` returns every leaf, its chunks concatenated along time,
keyed by its name. A leaf is named by its key path (`.obs.agents_view`,
`.info_episode_return`), sanitised for a file name, or by its position
(`leaf_i`) where those names collide.
"""

from __future__ import annotations

import json
import os
import re
from datetime import datetime
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree


def leaf_names(experience: Any) -> List[str]:
    """The name of each leaf of `experience`, in the order of its leaves."""
    paths = [path for path, _ in pytree.tree_flatten_with_path(experience)[0]]
    names = [re.sub(r"[^\w.]+", "_", pytree.keystr(path)).strip("_") for path in paths]
    if len(set(names)) != len(names) or any(not n for n in names):
        names = [f"leaf_{i}" for i in range(len(paths))]
    return names


def _numpy(x: Any) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class Vault:
    def __init__(
        self,
        vault_name: str,
        experience_structure: Optional[Any] = None,
        rel_dir: str = "vaults",
        vault_uid: Optional[str] = None,
    ):
        uid = vault_uid or datetime.now().strftime("%Y%m%d%H%M%S")
        self.base_dir = os.path.join(os.getcwd(), rel_dir, vault_name, uid)
        os.makedirs(self.base_dir, exist_ok=True)
        self._manifest_path = os.path.join(self.base_dir, "manifest.json")
        self._chunk_count = 0
        self._paths: Optional[List[str]] = None
        if os.path.exists(self._manifest_path):
            with open(self._manifest_path) as f:
                manifest = json.load(f)
            self._chunk_count = manifest["chunk_count"]
            self._paths = manifest["paths"]

    def write(self, experience: Any) -> int:
        """Append one slab (a pytree of tensors or arrays, leaves (batch, time,
        ...)); returns the number of elements written. Each leaf is written
        under its name, so a slab whose tree flattens in another order (the
        other package's) appends to the same files."""
        leaves = pytree.tree_leaves(experience)
        names = leaf_names(experience)
        if self._paths is None:
            self._paths = names
            with open(os.path.join(self.base_dir, "treedef.txt"), "w") as f:
                f.write(str(pytree.tree_structure(experience)))
        elif sorted(names) != sorted(self._paths):
            raise ValueError(f"the slab's leaves {sorted(names)} are not the vault's "
                             f"{sorted(self._paths)}")
        chunk_dir = os.path.join(self.base_dir, f"chunk_{self._chunk_count:06d}")
        os.makedirs(chunk_dir, exist_ok=True)
        written = 0
        for name, leaf in zip(names, leaves):
            arr = _numpy(leaf)
            np.save(os.path.join(chunk_dir, f"{name}.npy"), arr)
            written += arr.size
        self._chunk_count += 1
        with open(self._manifest_path, "w") as f:
            json.dump({"chunk_count": self._chunk_count, "paths": self._paths}, f)
        return written

    def read(self) -> Dict[str, np.ndarray]:
        """Every chunk, concatenated along the time axis, keyed by leaf name."""
        out: Dict[str, List[np.ndarray]] = {}
        for c in range(self._chunk_count):
            chunk_dir = os.path.join(self.base_dir, f"chunk_{c:06d}")
            for name in self._paths or []:
                out.setdefault(name, []).append(np.load(os.path.join(chunk_dir, f"{name}.npy")))
        return {k: np.concatenate(v, axis=1) for k, v in out.items()}
