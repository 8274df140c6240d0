"""CUDA graph capture, shared by the port's captured programs: the articulated
envs' integrator step (`envs/_dynamics.py` `CapturedStep`) and the SAC train
phase (`systems/sac/ff_isac.py`, `advanced_usage/ff_isac_vmap_seeds.py`), the
counterparts of the reference's `jax.jit` of the step and compiled `lax.scan`
of the train steps.

`Captured` runs a function once on a side stream (the warm-up that creates the
library handles and workspaces its ops need, and lets autograd see its first
run on that stream), then captures it on the same stream into the device's one
memory pool (`graph_pool`), and replays it. Host counters that the function
advances as it runs (kernel launches, optimizer counts, all-reduces) are rolled
back after the capture, which executes nothing, and advanced by what the
capture recorded at every replay. A capture that fails raises with the op that
failed (`failing_op`).

`CapturedPhase` is a phase of an update split into its draws, made on the host
in the order an eager loop makes them, and a body that reads and writes only
device tensors at fixed addresses (parameters, optimizer moments, a replay
ring). On CPU tensors the body runs op by op; on CUDA tensors the first call
runs the body for real as the warm-up and captures it, and every later call
copies its draws into the graph's static tensors and replays. A call whose
state no longer lives at the captured addresses (a restored checkpoint,
another learner's state) captures again, and says so: it never replays onto
other memory.
"""

from __future__ import annotations

import linecache
import os
import re
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils import _pytree as pytree

# The memory pool of every captured graph on a device: the graphs draw their
# intermediates and outputs from one pool. That is safe because each replay
# runs on the caller's stream, one after another, and the caller copies what
# it keeps of a replay's outputs before any other graph can run.
_GRAPH_POOLS: Dict[torch.device, Tuple[int, int]] = {}

_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# A host counter that a captured function advances: (object, attribute name).
Counter = Tuple[Any, str]


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
            before = [getattr(obj, name) for obj, name in counters]
            try:
                with torch.cuda.graph(self.graph, pool=graph_pool(device), stream=stream):
                    self.outputs = fn()
            except RuntimeError as error:
                raise RuntimeError(f"capturing {what} as a CUDA graph failed at "
                                   f"{failing_op(error)}: {error}") from error
            torch.cuda.current_stream(device).wait_stream(stream)
        # A capture executes nothing; every replay does what it recorded.
        self.advances = []
        for (obj, name), value in zip(counters, before):
            self.advances.append((obj, name, getattr(obj, name) - value))
            setattr(obj, name, value)
        self.seconds = time.perf_counter() - start

    def replay(self) -> Any:
        self.graph.replay()
        for obj, name, step in self.advances:
            setattr(obj, name, getattr(obj, name) + step)
        return self.outputs


def _address(t: torch.Tensor) -> Tuple:
    return t.data_ptr(), tuple(t.shape), tuple(t.stride()), t.dtype


class CapturedPhase:
    """A phase of an update: `draw(state, handed)` makes its random numbers (or
    takes the handed-in ones) as a pytree of tensors, `body(state, draws)`
    computes on the state's device tensors and returns a pytree of tensors.
    `state_tensors(state)` lists every tensor outside the draws that the body
    reads or writes, `counters(state)` the host counters it advances.

    A call draws, then runs the body: op by op on CPU tensors; on CUDA, the
    first call (and the first on a state at other addresses) runs the body
    for real on the capture stream and captures it, every later call copies
    its draws into the captured static tensors, replays, and returns copies of
    the outputs. `eager(state, handed)` is the phase op by op on any device.
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
        device = pytree.tree_leaves(draws)[0].device
        if device.type != "cuda":
            return self.body(state, draws)
        addresses = [_address(t) for t in self.state_tensors(state)]
        if self.graph is not None and addresses == self.addresses:
            for static, value in zip(pytree.tree_leaves(self.static), pytree.tree_leaves(draws)):
                static.copy_(value)
            return pytree.tree_map(torch.clone, self.graph.replay())
        if self.graph is not None:
            self.recaptures += 1
            print(f"{self.what}: the learner state is not at the captured addresses (a "
                  f"restore, or another learner's state): captured again "
                  f"({self.recaptures} re-capture{'s' if self.recaptures > 1 else ''})")
        self.graph = None  # the old graph's memory goes back to the pool first
        self.static = pytree.tree_map(lambda x: x.clone(memory_format=torch.contiguous_format),
                                      draws)
        self.graph = Captured(lambda: self.body(state, self.static), self.what, device,
                              self.counters(state))
        self.addresses = addresses
        self.captures += 1
        self.capture_seconds.append(self.graph.seconds)
        return self.graph.warm_up_result

    def eager(self, state: Any, handed: Any) -> Any:
        """The phase op by op: what a CUDA call ran until it was captured."""
        return self.body(state, self.draw(state, handed))
