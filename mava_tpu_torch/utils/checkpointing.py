"""Checkpointing on `torch.save` / `torch.load` (port of
`mava_tpu/utils/checkpointing.py`, which sits on orbax).

The reference's behaviour, kept: versioned checkpoints keyed by env-step under
`checkpoints/<model_name>/<uid>/<step>/`; `save_interval_steps`, `max_to_keep`
(the best by episode return stay) and `keep_period`; the config stored as
sanitised JSON beside `CHECKPOINTER_VERSION`, whose major version a restore
checks; `restore_params` with optional hidden states; and the full learner
state (`save(..., full_state=True)` / `restore_full_state`) for a resume that
continues exactly where the saved run stood.

A step directory holds `model.pt` ({params, hstates?}), with `full_state` also
`state.pt` (the whole learner state), and `metrics.json`. A learner state is
written as plain data (`to_host`): a module as its `state_dict`, a
`ClippedAdam` as its moments and count, a `torch.Generator` as its state (a
CUDA generator's too), tensors on the CPU, NamedTuples as lists, and the ints
a replay buffer keeps on the host as they are. So `torch.load` reads every
file with `weights_only=True`. `restore_into(template, saved)` puts it back
into a learner state of the same structure: modules, optimizer moments,
generators and leaf tensors that require grad in place (the optimizers and
the learner keep referring to them), every other tensor as a new tensor on
the template's device.

Under a process group (`parallel/`) the checkpointer is a collective that every
rank builds and calls: rank 0's directory token is broadcast, every rank's
learner state is gathered to rank 0, which alone writes, and a restore gives
each rank its own part. The saved state is the one-process layout of the
global batch: the fields that hold this rank's rows (envs, timesteps, hidden
states, rings) concatenated in rank order, the replicated ones (params,
optimizers, counters) once, and the generators every rank's, stacked.
"""

from __future__ import annotations

import json
import os
import shutil
from datetime import datetime
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from mava_tpu_torch.parallel.distributed import is_main_process
from mava_tpu_torch.parallel.mesh import Mesh, make_mesh
from mava_tpu_torch.utils.training import ClippedAdam

# Bump the major version on a breaking change of the checkpoint format; a
# restore asserts the same major version (reference :21).
CHECKPOINTER_VERSION = 1.0

_MODULE, _ADAM, _GENERATOR = "__module__", "__clipped_adam__", "__generator__"
# Every rank's generator state, (ranks, n) in rank order.
_GENERATORS = "__generators__"
# The fields of a learner state that hold the same values on every rank; the
# generator (`key`) is each rank's own; every other field holds this rank's
# rows of the global batch.
_REPLICATED = frozenset({"params", "opt_states", "opt_state", "time_steps", "train_steps", "t"})


def _sanitize(obj: Any) -> Any:
    """Make a config JSON-serialisable."""
    if isinstance(obj, dict):
        return {str(k): _sanitize(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_sanitize(v) for v in obj]
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    return str(obj)


def to_host(tree: Any) -> Any:
    """A learner state (or any part of it) as plain data for `torch.save`."""
    if isinstance(tree, torch.nn.Module):
        return {_MODULE: {k: v.detach().cpu().clone() for k, v in tree.state_dict().items()}}
    if isinstance(tree, ClippedAdam):
        return {_ADAM: {"mu": to_host(tree.mu), "nu": to_host(tree.nu), "count": tree.count}}
    if isinstance(tree, torch.Generator):
        return {_GENERATOR: tree.get_state()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().clone()
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_host(v) for v in tree]
    if tree is None or isinstance(tree, (bool, int, float, str)):
        return tree
    raise TypeError(f"Cannot checkpoint a {type(tree).__name__}.")


def differences(got: Any, want: Any, where: str = "state") -> List[Tuple[str, float]]:
    """(path, largest |difference|) of every leaf of two `to_host` trees that
    is not bitwise equal; nan where the structure, shape or dtype differs."""
    if isinstance(want, torch.Tensor):
        if not isinstance(got, torch.Tensor) or got.shape != want.shape \
                or got.dtype != want.dtype:
            return [(where, float("nan"))]
        if torch.equal(got, want):
            return []
        if want.is_floating_point():
            return [(where, (got.double() - want.double()).abs().max().item())]
        return [(where, float((got != want).sum()))]
    if isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            return [(where, float("nan"))]
        return [d for k in want for d in differences(got[k], want[k], f"{where}.{k}")]
    if isinstance(want, (list, tuple)):
        if not isinstance(got, (list, tuple)) or len(got) != len(want):
            return [(where, float("nan"))]
        return [d for i, (g, w) in enumerate(zip(got, want))
                for d in differences(g, w, f"{where}[{i}]")]
    return [] if got == want else [(where, float("nan"))]


def _mismatch(what: str, template: Any, saved: Any) -> ValueError:
    return ValueError(f"Checkpoint does not fit the learner state at {what}: "
                      f"{type(template).__name__} vs {type(saved).__name__}.")


@torch.no_grad()
def restore_into(template: Any, saved: Any, where: str = "state") -> Any:
    """`saved` (from `to_host`) put back into a learner state shaped like
    `template`; returns the restored state."""
    if isinstance(template, torch.nn.Module):
        template.load_state_dict(saved[_MODULE], strict=True)
        return template
    if isinstance(template, ClippedAdam):
        opt = saved[_ADAM]
        for dst, src in zip(template.mu + template.nu, opt["mu"] + opt["nu"], strict=True):
            dst.copy_(src)
        template.count = int(opt["count"])
        return template
    if isinstance(template, torch.Generator):
        template.set_state(saved[_GENERATOR])
        return template
    if isinstance(template, torch.Tensor):
        if not isinstance(saved, torch.Tensor) or saved.shape != template.shape \
                or saved.dtype != template.dtype:
            raise _mismatch(where, template, saved)
        if template.requires_grad:  # a leaf an optimizer holds (SAC's log_alpha)
            return template.copy_(saved)
        return saved.to(template.device)
    if isinstance(template, dict):
        if set(template) != set(saved):
            raise ValueError(f"Checkpoint keys at {where} differ: {sorted(saved)} vs "
                             f"{sorted(template)}.")
        return {k: restore_into(v, saved[k], f"{where}.{k}") for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        if not isinstance(saved, (list, tuple)) or len(saved) != len(template):
            raise _mismatch(where, template, saved)
        items = [restore_into(t, s, f"{where}[{i}]")
                 for i, (t, s) in enumerate(zip(template, saved))]
        if hasattr(template, "_fields"):
            return type(template)(*items)
        return type(template)(items)
    if template is None or isinstance(template, (bool, int, float, str)):
        return saved
    raise _mismatch(where, template, saved)


def _broadcast(value: Any) -> Any:
    """Rank 0's `value` on every rank (itself without a process group)."""
    if not dist.is_initialized():
        return value
    box = [value]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def gather_state(state: Any, fields: Sequence[str], mesh: Mesh) -> Optional[Dict[str, Any]]:
    """{field: `to_host`} of the learner state's `fields`, every rank's joined
    into the one-process layout (see the module's docstring), on rank 0; None
    on the other ranks."""
    host = [to_host(getattr(state, name)) for name in fields]
    if mesh.world_size == 1:
        return dict(zip(fields, host))
    every = [None] * mesh.world_size if mesh.rank == 0 else None
    dist.gather_object(host, every, dst=0)
    if mesh.rank != 0:
        return None
    joined = {}
    for i, name in enumerate(fields):
        trees = [e[i] for e in every]
        if name in _REPLICATED:
            joined[name] = trees[0]
        elif name == "key":
            joined[name] = {_GENERATORS: torch.stack([t[_GENERATOR] for t in trees])}
        else:
            joined[name] = pytree.tree_map(
                lambda *xs: torch.cat(xs) if isinstance(xs[0], torch.Tensor) and xs[0].dim() > 0
                else xs[0], *trees)
    return joined


def split_state(saved: list, template: Any, mesh: Mesh) -> list:
    """This rank's part of a state that `gather_state` joined: its rows of
    every sharded field and its generator; unchanged without a process group."""
    if mesh.world_size == 1:
        return saved
    out = []
    for i, name in enumerate(template._fields):
        part = saved[i]
        if name == "key":
            # A row of its own: `Generator.set_state` reads from the storage's start.
            part = {_GENERATOR: part[_GENERATORS][mesh.rank].clone()}
        elif name not in _REPLICATED:
            part = split_rows(part, mesh)
        out.append(part)
    return out


def split_rows(tree: Any, mesh: Mesh) -> Any:
    """This rank's rows of every tensor of a joined host tree."""
    def take(x: Any) -> Any:
        if not isinstance(x, torch.Tensor) or x.dim() == 0:
            return x
        n = x.shape[0] // mesh.world_size
        return x[mesh.rank * n : (mesh.rank + 1) * n]

    return pytree.tree_map(take, tree)


class Checkpointer:
    """Save and restore learner states keyed by env-step."""

    def __init__(
        self,
        model_name: str,
        metadata: Optional[dict] = None,
        rel_dir: str = "checkpoints",
        checkpoint_uid: Optional[str] = None,
        save_interval_steps: int = 1,
        max_to_keep: Optional[int] = 1,
        keep_period: Optional[int] = None,
    ):
        self.mesh = make_mesh()
        uid = checkpoint_uid or _broadcast(datetime.now().strftime("%Y%m%d%H%M%S"))
        self.directory = os.path.join(os.getcwd(), rel_dir, model_name, uid)
        self.save_interval_steps = save_interval_steps
        self.max_to_keep = max_to_keep
        self.keep_period = keep_period
        if not is_main_process():
            return
        os.makedirs(self.directory, exist_ok=True)
        meta_path = os.path.join(self.directory, "metadata.json")
        if metadata is not None or not os.path.exists(meta_path):
            meta = _sanitize(dict(metadata) if metadata is not None else {})
            meta["checkpointer_version"] = CHECKPOINTER_VERSION
            with open(meta_path, "w") as f:
                json.dump(meta, f)

    # ------------------------------------------------------------------ steps
    def all_steps(self) -> List[int]:
        return sorted(int(d) for d in os.listdir(self.directory) if d.isdigit())

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _metric(self, step: int) -> Optional[float]:
        path = os.path.join(self.directory, str(step), "metrics.json")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return float(json.load(f)["episode_return"])

    def best_step(self) -> Optional[int]:
        scored = [(self._metric(s), s) for s in self.all_steps()]
        scored = [(m, s) for m, s in scored if m is not None]
        return max(scored)[1] if scored else None

    def _remove_old_checkpoints(self) -> None:
        """Keep the `max_to_keep` best by episode return (ties to the later),
        and every step that `keep_period` divides, as orbax's manager does."""
        if self.max_to_keep is None:
            return
        metrics = {s: self._metric(s) for s in self.all_steps()}
        ranked = sorted((-float("inf") if m is None else m, s) for s, m in metrics.items())
        for _, step in ranked[: max(len(ranked) - self.max_to_keep, 0)]:
            if self.keep_period and step % self.keep_period == 0:
                continue
            shutil.rmtree(os.path.join(self.directory, str(step)))

    # ------------------------------------------------------------------ save
    def save(self, timestep: int, unreplicated_learner_state: Any,
             episode_return: float = 0.0, full_state: bool = False) -> bool:
        """Save {params, hstates?} at an env-step, tracked by episode return;
        with `full_state` also the whole learner state (reference :104-141).
        Returns False where `save_interval_steps` skips the step. A
        collective under a process group: rank 0 decides and writes."""
        latest = self.latest_step() if is_main_process() else None
        if not _broadcast(timestep % self.save_interval_steps == 0
                          and (latest is None or timestep > latest)):
            return False
        state = unreplicated_learner_state
        fields = state._fields if full_state else [
            f for f in ("params", "hstates") if getattr(state, f, None) is not None]
        host = gather_state(state, fields, self.mesh)
        if host is None:  # not rank 0
            return True
        item = {k: host[k] for k in ("params", "hstates") if k in host}
        step_dir = os.path.join(self.directory, str(timestep))
        tmp = f"{step_dir}.tmp"
        os.makedirs(tmp, exist_ok=True)
        torch.save(item, os.path.join(tmp, "model.pt"))
        if full_state:
            torch.save([host[f] for f in fields], os.path.join(tmp, "state.pt"))
        with open(os.path.join(tmp, "metrics.json"), "w") as f:
            json.dump({"episode_return": float(episode_return)}, f)
        os.replace(tmp, step_dir)
        self._remove_old_checkpoints()
        return True

    # ------------------------------------------------------------------ restore
    def _step_dir(self, timestep: Optional[int]) -> str:
        with open(os.path.join(self.directory, "metadata.json")) as f:
            version = float(json.load(f).get("checkpointer_version", CHECKPOINTER_VERSION))
        if int(version) != int(CHECKPOINTER_VERSION):
            raise ValueError(f"Incompatible checkpoint major version: saved {version}, "
                             f"current {CHECKPOINTER_VERSION}")
        step = self.latest_step() if timestep is None else timestep
        if step is None:
            raise FileNotFoundError(f"No checkpoint under {self.directory}.")
        return os.path.join(self.directory, str(step))

    def _load(self, step_dir: str, name: str) -> Any:
        path = os.path.join(step_dir, name)
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"Checkpoint step {os.path.basename(step_dir)} at {step_dir} has no {name}: "
                "the checkpoint is missing or corrupted.")
        return torch.load(path, map_location="cpu", weights_only=True)

    def restore_state(self, template: Dict[str, Any], timestep: Optional[int] = None) -> Any:
        """Restore the {params, hstates?} item into `template`."""
        saved = self._load(self._step_dir(timestep), "model.pt")
        if "hstates" in saved:
            saved["hstates"] = split_rows(saved["hstates"], self.mesh)
        return {k: restore_into(v, saved[k], k) for k, v in template.items()}

    def restore_full_state(self, template: Any, timestep: Optional[int] = None) -> Any:
        """Restore the whole learner state saved with `full_state=True` into
        `template`, a learner state of the same structure; the resumed run
        continues exactly (reference :171-182)."""
        saved = self._load(self._step_dir(timestep), "state.pt")
        return restore_into(template, split_state(saved, template, self.mesh))

    def restore_params(self, input_params: Any, restore_hstates: bool = False,
                       input_hstates: Any = None,
                       timestep: Optional[int] = None) -> Tuple[Any, Any]:
        """(params, hidden states or None) of a saved learner state; resume is
        params-level, as in the reference (:184-201)."""
        template = {"params": input_params}
        if restore_hstates and input_hstates is not None:
            template["hstates"] = input_hstates
        restored = self.restore_state(template, timestep)
        return restored["params"], restored.get("hstates")

    def get_cfg(self) -> dict:
        with open(os.path.join(self.directory, "metadata.json")) as f:
            return json.load(f)
