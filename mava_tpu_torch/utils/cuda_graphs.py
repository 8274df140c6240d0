"""CUDA graph capture, shared by the port's captured programs: the articulated
envs' integrator step (`envs/_dynamics.py` `CapturedStep`), the SAC train
phase (`systems/sac/ff_isac.py`, `advanced_usage/ff_isac_vmap_seeds.py`),
the whole rec-IQL update, stock (`systems/q_learning/rec_iql.py`) and stacked
over seeds or a sweep (`advanced_usage/rec_iql_vmap_seeds.py`), and the whole
PPO update of ff-IPPO and ff-MAPPO (`systems/ppo/ff_ippo.py`) and of
rec-IPPO and rec-MAPPO (`systems/ppo/rec_ippo.py`), the counterparts of the
reference's `jax.jit` of the step and compiled `lax.scan`s of the rollout,
the act and train steps and the epochs. A graph is not captured inside
another: while a stream captures, the integrator runs its step op by op.

`Captured` runs a function once on a side stream (the warm-up that creates the
library handles and workspaces its ops need, and lets autograd see its first
run on that stream), then captures it on the same stream into the device's one
memory pool (`graph_pool`), and replays it. Host counters that the function
advances as it runs (kernel launches, optimizer counts, all-reduces) are rolled
back after the capture, which executes nothing, and advanced by what the
capture recorded at every replay: an attribute of an object, or every key of
a dict of counts (the GRU op's launches by kernel and by shape). A capture
that fails raises with the op that failed (`failing_op`).

`CapturedPhase` is a phase of an update split into its inputs (the draws, made
on the host in the order an eager loop makes them, and any state the phase
carries from call to call by value), and a body that reads and writes only
device tensors at fixed addresses (parameters, optimizer moments, a replay
ring). On CPU tensors the body runs op by op; on CUDA tensors the first call
runs the body for real as the warm-up and captures it, and every later call
copies its draws into the graph's static tensors and replays. An input or
output leaf that is no tensor (the None of a field a system does not carry)
is passed through as it is. A call whose
state no longer lives at the captured addresses (a restored checkpoint,
another learner's state) captures again, and says so: it never replays onto
other memory.
"""

from __future__ import annotations

import gc
import linecache
import os
import re
import time
import traceback
from typing import Any, Callable, Dict, List, MutableMapping, Optional, Sequence, Tuple, Union

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import is_in_torch_dispatch_mode

# The memory pool of every captured graph on a device: the graphs draw their
# intermediates and outputs from one pool. That is safe because each replay
# runs on the caller's stream, one after another, and the caller copies what
# it keeps of a replay's outputs before any other graph can run.
_GRAPH_POOLS: Dict[torch.device, Tuple[int, int]] = {}

_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# A host counter that a captured function advances: (object, attribute name),
# or a dict whose every value is a count.
Counter = Union[Tuple[Any, str], MutableMapping]


def _read(counter: Counter) -> Any:
    if isinstance(counter, MutableMapping):
        return dict(counter)
    obj, name = counter
    return getattr(obj, name)


def _restore(counter: Counter, value: Any) -> None:
    if isinstance(counter, MutableMapping):
        counter.clear()
        counter.update(value)
    else:
        setattr(*counter, value)


def _advance(counter: Counter, step: Any) -> None:
    if isinstance(counter, MutableMapping):
        for key, n in step.items():
            counter[key] = counter.get(key, 0) + n
    else:
        obj, name = counter
        setattr(obj, name, getattr(obj, name) + step)


def graph_pool(device: torch.device) -> Tuple[int, int]:
    """The shared memory pool of the captured graphs on `device` ("cuda" is the
    current card)."""
    device = torch.device("cuda", torch.cuda.current_device() if device.index is None
                          else device.index)
    if device not in _GRAPH_POOLS:
        with torch.cuda.device(device):
            _GRAPH_POOLS[device] = torch.cuda.graph_pool_handle()
    return _GRAPH_POOLS[device]


def failing_op(error: BaseException, elsewhere: str = "an op outside the port") -> str:
    """Where `error`, or an error it arose from, was raised: the ATen op on the
    line of a traced graph, else the innermost line of the port's code (file,
    line and source), else `elsewhere`."""
    frames = []
    while error is not None:
        frames.extend(reversed(list(traceback.walk_tb(error.__traceback__))))
        error = error.__cause__ or error.__context__
    for frame, lineno in frames:
        filename = frame.f_code.co_filename
        if filename.startswith("<eval_with_key>"):
            op = re.search(r"torch\.ops\.([\w.]+)", linecache.getline(filename, lineno))
            if op:
                return op.group(1)
    for frame, lineno in frames:
        filename = os.path.abspath(frame.f_code.co_filename)
        if filename.startswith(_PACKAGE) and filename != os.path.abspath(__file__):
            where = os.path.relpath(filename, os.path.dirname(_PACKAGE))
            return f"{where}:{lineno} ({linecache.getline(filename, lineno).strip()})"
    return elsewhere


class Captured:
    """`fn()` captured once as a CUDA graph on `device`; `replay()` runs it
    again and returns its static outputs, which the next replay, or another
    graph of the pool, overwrites. `fn` first runs for real on the capture
    stream (the warm-up); `warm_up_result` holds what it returned. `counters`
    are the host counters `fn` advances: the capture's advance is rolled back
    and every replay adds it. `seconds` is the warm-up and the capture."""

    def __init__(self, fn: Callable[[], Any], what: str, device: torch.device,
                 counters: Sequence[Counter] = ()):
        start = time.perf_counter()
        with torch.cuda.device(device):
            stream = torch.cuda.Stream(device)
            stream.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(stream):
                self.warm_up_result = fn()
            self.graph = torch.cuda.CUDAGraph()
            before = [_read(counter) for counter in counters]
            # No garbage collection inside the capture: a collection there can
            # free another graph that only a reference cycle still held (a
            # discarded learner), and a graph's reset is not permitted while a
            # stream captures. Such graphs are freed here, just before.
            gc.collect()
            collecting = gc.isenabled()
            gc.disable()
            try:
                with torch.cuda.graph(self.graph, pool=graph_pool(device), stream=stream):
                    self.outputs = fn()
            except RuntimeError as error:
                raise RuntimeError(f"capturing {what} as a CUDA graph failed at "
                                   f"{failing_op(error)}: {error}") from error
            finally:
                if collecting:
                    gc.enable()
            torch.cuda.current_stream(device).wait_stream(stream)
        # A capture executes nothing; every replay does what it recorded.
        self.advances = []
        for counter, value in zip(counters, before):
            after = _read(counter)
            if isinstance(counter, MutableMapping):
                step = {k: n - value.get(k, 0) for k, n in after.items() if n != value.get(k, 0)}
            else:
                step = after - value
            self.advances.append((counter, step))
            _restore(counter, value)
        self.seconds = time.perf_counter() - start

    def replay(self) -> Any:
        self.graph.replay()
        for counter, step in self.advances:
            _advance(counter, step)
        return self.outputs


def _address(t: torch.Tensor) -> Tuple:
    return t.data_ptr(), tuple(t.shape), tuple(t.stride()), t.dtype


def _copy(x: Any) -> Any:
    """A copy of a tensor leaf; any other leaf (the None of a carry's unused
    field) as it is."""
    return x.clone() if isinstance(x, torch.Tensor) else x


def _tensors(tree: Any) -> List[torch.Tensor]:
    return [x for x in pytree.tree_leaves(tree) if isinstance(x, torch.Tensor)]


class CapturedPhase:
    """A phase of an update: `draw(state, handed)` makes its inputs, its random
    numbers (or the handed-in ones) and any state it carries by value, as a
    pytree of tensors (a leaf that is no tensor, such as the None of a draw an
    env does not make, is held as it is), `body(state, draws)` computes on
    them and on the state's device tensors and returns a pytree of tensors.
    `state_tensors(state)` lists every tensor outside the draws that the body
    reads or writes, `counters(state)` the host counters it advances.

    A call draws, then runs the body: op by op on CPU tensors, and under a
    Python dispatch mode that watches the ops (a FLOP counter, an op
    recorder), which a replay would run unseen; on CUDA, the first call (and
    the first on a state at other addresses) runs the body for real on the
    capture stream and captures it, every later call copies its draws into
    the captured static tensors, replays, and returns copies of the outputs.
    `eager(state, handed)` is the phase op by op on any device.
    """

    def __init__(self, draw: Callable, body: Callable, state_tensors: Callable[[Any], List],
                 counters: Callable[[Any], Sequence[Counter]], what: str):
        self.draw, self.body = draw, body
        self.state_tensors, self.counters = state_tensors, counters
        self.what = what
        self.graph: Optional[Captured] = None
        self.static: Any = None
        self.addresses: Optional[List[Tuple]] = None
        self.captures = 0
        self.recaptures = 0
        self.capture_seconds: List[float] = []

    def __call__(self, state: Any, handed: Any) -> Any:
        draws = self.draw(state, handed)
        device = _tensors(draws)[0].device
        if device.type != "cuda" or is_in_torch_dispatch_mode():
            return self.body(state, draws)
        addresses = [_address(t) for t in self.state_tensors(state)]
        if self.graph is not None and addresses == self.addresses:
            for static, value in zip(_tensors(self.static), _tensors(draws)):
                static.copy_(value)
            return pytree.tree_map(_copy, self.graph.replay())
        if self.graph is not None:
            self.recaptures += 1
            print(f"{self.what}: the learner state is not at the captured addresses (a "
                  f"restore, or another learner's state): captured again "
                  f"({self.recaptures} re-capture{'s' if self.recaptures > 1 else ''})")
        self.graph = None  # the old graph's memory goes back to the pool first
        self.static = pytree.tree_map(
            lambda x: x.clone(memory_format=torch.contiguous_format)
            if isinstance(x, torch.Tensor) else x, draws)
        self.graph = Captured(lambda: self.body(state, self.static), self.what, device,
                              self.counters(state))
        self.addresses = addresses
        self.captures += 1
        self.capture_seconds.append(self.graph.seconds)
        return self.graph.warm_up_result

    def eager(self, state: Any, handed: Any) -> Any:
        """The phase op by op: what a CUDA call ran until it was captured."""
        return self.body(state, self.draw(state, handed))
