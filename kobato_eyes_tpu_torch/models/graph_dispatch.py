"""One batch's device work replayed from a captured CUDA graph, and each batch
completed on an event of its own.

A tagger's dispatch runs the batch's whole device work: normalisation, the
forward, the probabilities, the mode's device selection, and the selection's
tensors packed into one float64 vector (:func:`pack`; float64 holds every
f32 score and every index exactly). :class:`BatchGraphs` runs that work
eager, or captures it into a CUDA graph that reads a static input buffer
(the tagger's threshold buffer is static too) and writes one static packed
output, and replays it. Either way the packed output is copied on the stream
into a pinned host slot of its own (:class:`SlotPool`) and an event is
recorded behind the copy (:class:`InFlight`). A replay overwrites the static
output, so the batches in flight cannot share it; and the completion waits
for its own batch's event, not for the newest forward on the stream.

The rules (:func:`dispatch_mode`), chosen from what the caller can observe:
a graph only on one CUDA device (no mesh, never the CPU), captured by a
thread that has run the key eager before (a key's first dispatch on each
thread runs eager, which also makes what a capture must not: the GELU
tables, the rsqrt table's upload, the kernels' libraries, the thread's cuBLAS
handle), replayed by any thread, for at most :data:`MAX_GRAPHS` keys, the
least recently used dropped. A failed capture raises. The ops modules' launch counters (module attributes whose
name holds ``launches``, ints or dicts of ints) keep counting launches: the
change a capture made to them is taken back and added again at every replay
(:func:`launch_counts`, :func:`add_counts`).
"""

from __future__ import annotations

import math
import sys
import threading
from collections import OrderedDict
from typing import Any, Callable, Hashable, Sequence

import numpy as np
import torch

from kobato_eyes_tpu_torch.utils.tracing import span

MAX_GRAPHS = 4  # keys (a batch shape, dtype and the select's static arguments) kept at once
MAX_FREE_SLOTS = 16  # pinned slots kept for reuse after their batches completed
_OPS_PREFIX = "kobato_eyes_tpu_torch.ops."

Layout = tuple[tuple[tuple[int, ...], np.dtype], ...]


def pack(tensors: Sequence[torch.Tensor]) -> tuple[torch.Tensor, Layout]:
    """The tensors flattened into one float64 vector on their device, and the
    shapes and dtypes that :func:`unpack` gives them back."""
    layout = tuple((tuple(t.shape), torch.empty((), dtype=t.dtype).numpy().dtype) for t in tensors)
    return torch.cat([t.reshape(-1).to(torch.float64) for t in tensors]), layout


def unpack(flat: np.ndarray, layout: Layout) -> list[np.ndarray]:
    """The arrays :func:`pack` flattened, each in its own dtype and shape;
    copies, so ``flat`` may be written again."""
    out: list[np.ndarray] = []
    offset = 0
    for shape, dtype in layout:
        n = math.prod(shape)
        out.append(flat[offset : offset + n].reshape(shape).astype(dtype))
        offset += n
    return out


def fetch(tensors: Sequence[torch.Tensor]) -> list[np.ndarray]:
    """Small result tensors copied to the host in one transfer (one sync),
    each back in its own dtype and shape."""
    flat, layout = pack(tensors)
    return unpack(flat.cpu().numpy(), layout)


def dispatch_mode(device: torch.device, on_mesh: bool, ran_here: bool, captured: bool) -> str:
    """How a dispatch of a key runs: ``"eager"``, ``"capture"`` (then
    replay) or ``"replay"``. ``ran_here``: the calling thread has run the
    key eager before."""
    if device.type != "cuda" or on_mesh:
        return "eager"
    if captured:
        return "replay"
    return "capture" if ran_here else "eager"


def launch_counts() -> dict[tuple[str, str, Any], int]:
    """Every launch counter of the loaded ops modules, by (module, attribute,
    key of a dict counter or None)."""
    counts: dict[tuple[str, str, Any], int] = {}
    for name, module in list(sys.modules.items()):
        if not name.startswith(_OPS_PREFIX) or module is None:
            continue
        for attr, value in list(vars(module).items()):
            if "launches" not in attr:
                continue
            if isinstance(value, dict):
                counts.update({(name, attr, k): v for k, v in value.items() if isinstance(v, int)})
            elif isinstance(value, int) and not isinstance(value, bool):
                counts[(name, attr, None)] = value
    return counts


def counts_moved(before: dict, after: dict) -> dict:
    """The counters that moved from ``before`` to ``after``, by how much."""
    moved = {k: v - before.get(k, 0) for k, v in after.items()}
    return {k: d for k, d in moved.items() if d}


def add_counts(delta: dict, sign: int = 1) -> None:
    """Add ``sign * delta`` to the counters it names (their current objects:
    a caller may have reset a counter to a new int or dict since)."""
    for (name, attr, key), d in delta.items():
        module = sys.modules[name]
        if key is None:
            setattr(module, attr, getattr(module, attr) + sign * d)
        else:
            table = getattr(module, attr)
            table[key] = table.get(key, 0) + sign * d


class SlotPool:
    """Float64 host slots, pinned for a CUDA device: one a batch in flight,
    taken back when the batch completes. It grows as needed; a slot is on
    the free list only between its release and its next acquire."""

    def __init__(self, *, pinned: bool) -> None:
        self._pinned = pinned
        self._free: list[torch.Tensor] = []
        self._lock = threading.Lock()

    def acquire(self, n: int) -> torch.Tensor:
        with self._lock:
            for i, slot in enumerate(self._free):
                if slot.numel() == n:
                    return self._free.pop(i)
        return torch.empty(n, dtype=torch.float64, device="cpu", pin_memory=self._pinned)

    def release(self, slot: torch.Tensor) -> None:
        with self._lock:
            self._free.append(slot)
            del self._free[:-MAX_FREE_SLOTS]


class InFlight:
    """One dispatched batch's packed result: a host slot the stream copies
    into, the event behind that copy (None where the work ran on the CPU and
    is done), and the pool that takes the slot back."""

    def __init__(self, slot: torch.Tensor, layout: Layout, event=None, pool: SlotPool | None = None) -> None:
        self.slot, self.layout, self.event, self.pool = slot, layout, event, pool

    def wait(self) -> list[np.ndarray]:
        """Wait for this batch alone, then its arrays; the slot goes back."""
        if self.event is not None:
            self.event.synchronize()
        out = unpack(self.slot.numpy(), self.layout)
        if self.pool is not None:
            self.pool.release(self.slot)
            self.pool = None
        return out


class _Entry:
    def __init__(self) -> None:
        self.eager_threads: set[int] = set()  # threads that ran the key eager
        self.graph = None
        self.static_in: torch.Tensor | None = None
        self.packed: torch.Tensor | None = None
        self.layout: Layout = ()
        self.moved: dict = {}  # launch counters a replay adds


class BatchGraphs:
    """A tagger's captured dispatches: the cache of graphs by key, the slot
    pool and the counters ``graph_captures``, ``graph_replays`` and
    ``eager_dispatches``. Callers serialise :meth:`dispatch`."""

    def __init__(self, device: torch.device, *, on_mesh: bool) -> None:
        self.device = device
        self.on_mesh = on_mesh
        self.slots = SlotPool(pinned=device.type == "cuda")
        self._entries: OrderedDict[Hashable, _Entry] = OrderedDict()
        self.graph_captures = self.graph_replays = self.eager_dispatches = 0

    def _entry(self, key: Hashable) -> _Entry:
        entry = self._entries.pop(key, None) or _Entry()
        self._entries[key] = entry
        while len(self._entries) > MAX_GRAPHS:
            _, dropped = self._entries.popitem(last=False)
            if dropped.graph is not None:
                # a replay of it may still run: its memory goes back once the stream is past it
                torch.cuda.current_stream(self.device).synchronize()
        return entry

    def dispatch(
        self,
        key: Hashable,
        batch: np.ndarray | torch.Tensor,
        *,
        upload: Callable[[Any], torch.Tensor],
        work: Callable[[torch.Tensor], Sequence[torch.Tensor]],
    ) -> InFlight:
        """Run one batch's device work and start its copy to the host.

        ``work(x)`` computes the result tensors from ``x = upload(batch)``,
        the batch on the device, op by op; a capture records it reading the
        static input buffer that the batch is copied into instead."""
        entry = self._entry(key)
        thread = threading.get_ident()
        mode = dispatch_mode(self.device, self.on_mesh, thread in entry.eager_threads, entry.graph is not None)
        if mode == "eager":
            self.eager_dispatches += 1
            entry.eager_threads.add(thread)
            return self._send(*pack(work(upload(batch))))
        source = batch if isinstance(batch, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(batch))
        with torch.cuda.device(self.device):
            if mode == "capture":
                entry.static_in = torch.empty(source.shape, dtype=source.dtype, device=self.device)
            with span("tagger.upload"):
                entry.static_in.copy_(source)
            if mode == "capture":
                self._capture(entry, work)
            with span("tagger.replay"):
                entry.graph.replay()
                add_counts(entry.moved)
            self.graph_replays += 1
            return self._send(entry.packed, entry.layout)

    def _capture(self, entry: _Entry, work: Callable[[torch.Tensor], Sequence[torch.Tensor]]) -> None:
        before = launch_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            entry.packed, entry.layout = pack(work(entry.static_in))
        entry.moved = counts_moved(before, launch_counts())
        add_counts(entry.moved, -1)  # nothing ran yet: each replay counts its launches
        entry.graph = graph
        self.graph_captures += 1

    def _send(self, packed: torch.Tensor, layout: Layout) -> InFlight:
        if packed.device.type != "cuda":
            return InFlight(packed, layout)
        slot = self.slots.acquire(packed.numel())
        slot.copy_(packed, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(packed.device))
        return InFlight(slot, layout, event, self.slots)
