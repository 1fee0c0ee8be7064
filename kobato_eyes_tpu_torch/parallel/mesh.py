"""Device mesh construction and sharding rules for the ViT family.

Counterpart of ``kobato_eyes_tpu/parallel/mesh.py``. Axes: ``data`` (batch /
file-row shards) x ``model`` (head / MLP / label tensor parallelism). With
``model=1`` this degenerates to pure data parallelism.

A :class:`Mesh` is a (data, model) grid of ``torch.device`` entries. An entry
may repeat a device (``["cpu"] * 8`` in the tests, ``["cuda:0"] * 4`` on one
card): the shards are then separate tensors on that device, which is how the
JAX package's virtual CPU devices stand in for chips. Where the JAX package
lets GSPMD place tensors and insert collectives, the port's sharded paths
hold one tensor per mesh entry and copy explicitly between them.

Parameters are partitioned by name-pattern rules over timm's state-dict
names (already strings, so the JAX module's ``_path_str``, which joins flax
key paths, has no counterpart); everything unmatched is replicated, and so
is a tensor whose partitioned dimension does not divide the model axis.
"""

from __future__ import annotations

import collections
import dataclasses
import re
from typing import Mapping, Sequence

import numpy as np
import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"


class Mesh:
    """A (data, model) grid of ``torch.device`` entries.

    ``process_ids`` says which process of a ``torch.distributed`` cluster
    drives each entry (all 0 outside a cluster; ``parallel/distributed.py``
    builds a mesh that spans processes). The sharded entry points of this
    package drive the entries of one process: :attr:`local_devices`.
    """

    axis_names = (DATA_AXIS, MODEL_AXIS)

    def __init__(self, devices: Sequence[Sequence], process_ids: Sequence[Sequence[int]] | None = None) -> None:
        grid = [[torch.device(d) for d in row] for row in devices]
        if not grid or not grid[0] or any(len(row) != len(grid[0]) for row in grid):
            raise ValueError("a mesh is a non-empty rectangular (data, model) grid of devices")
        self.devices = np.empty((len(grid), len(grid[0])), dtype=object)
        for r, row in enumerate(grid):
            for m, dev in enumerate(row):
                self.devices[r, m] = dev
        ids = np.zeros(self.devices.shape, dtype=np.int64) if process_ids is None else np.asarray(process_ids)
        if ids.shape != self.devices.shape:
            raise ValueError(f"process ids {ids.shape} do not match the device grid {self.devices.shape}")
        self.process_ids = ids.astype(np.int64)
        self._key = (tuple(str(d) for d in self.devices.flat), self.devices.shape, tuple(self.process_ids.flat))

    @property
    def shape(self) -> "collections.OrderedDict[str, int]":
        return collections.OrderedDict(zip(self.axis_names, self.devices.shape))

    @property
    def local_devices(self) -> np.ndarray:
        """The device grid, which this process drives entirely; raises for a
        mesh with entries of other processes."""
        rank = _process_index()
        if (self.process_ids != rank).any():
            raise ValueError(
                f"mesh spans processes {sorted(set(self.process_ids.flat))}: the sharded paths of this "
                f"package drive one process's devices (this is process {rank})"
            )
        return self.devices

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Mesh) and self._key == other._key

    def __hash__(self) -> int:
        return hash(self._key)

    def __repr__(self) -> str:
        return f"Mesh({dict(self.shape)}, devices={[str(d) for d in self.devices.flat]})"


def _process_index() -> int:
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def visible_devices(kind: str = "cuda") -> list[torch.device]:
    """The devices of ``kind`` this process sees: the CUDA cards (raises
    without one), or the one CPU."""
    if kind == "cpu":
        return [torch.device("cpu")]
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError("no CUDA device visible: pass devices= (e.g. ['cpu'] * 8) to build a mesh")
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(
    *,
    data: int = -1,
    model: int = 1,
    devices: Sequence | None = None,
) -> Mesh:
    """Build a (data, model) mesh. ``data=-1`` = all remaining devices.

    ``devices`` is taken as given, repeats included; without it the mesh
    spans the visible cards (:func:`visible_devices`)."""
    devs = list(devices) if devices is not None else visible_devices()
    n = len(devs)
    if model < 1 or n % model != 0:
        raise ValueError(f"model axis {model} must divide device count {n}")
    if data == -1:
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    return Mesh([devs[r * model : (r + 1) * model] for r in range(data)])


# -- parameter partitioning --------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Sharding:
    """How one tensor lies over the mesh's model axis.

    ``spec`` names the mesh axis of each tensor dimension (all ``None``:
    replicated, a copy on every entry). The partitioned dimension is read
    as ``(outer, units, rest)`` and its ``units`` split into contiguous
    runs, one a model entry: timm's qkv rows are (3, heads, head_dim), so a
    head shard takes the same heads from each of q, k and v.
    """

    spec: tuple
    outer: int = 1
    units: int = 0

    @property
    def replicated(self) -> bool:
        return MODEL_AXIS not in self.spec

    def shard(self, tensor: torch.Tensor, index: int, count: int) -> torch.Tensor:
        """Model entry ``index`` of ``count``'s part of ``tensor``."""
        if self.replicated:
            return tensor
        dim = self.spec.index(MODEL_AXIS)
        per = self.units // count
        view = tensor.unflatten(dim, (self.outer, self.units, -1))
        return view.narrow(dim + 1, index * per, per).flatten(dim, dim + 2).contiguous()

    def gather(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """The whole tensor from the model entries' parts, in entry order, on
        the first part's device: the inverse of :meth:`shard`."""
        if self.replicated:
            return parts[0]
        dim = self.spec.index(MODEL_AXIS)
        per = self.units // len(parts)
        views = [p.to(parts[0].device).unflatten(dim, (self.outer, per, -1)) for p in parts]
        return torch.cat(views, dim=dim + 1).flatten(dim, dim + 2)


# name pattern -> (partitioned dim, outer groups, unit: "heads" or "rows"):
# the ViT's big tensors in timm names (JAX: the flax paths of _VIT_RULES)
_VIT_RULES: tuple[tuple[str, int, int, str], ...] = (
    # attention: qkv (3*D, D) rows in (3, heads, head_dim) order — shard heads
    (r"attn\.qkv\.weight$", 0, 3, "heads"),
    (r"attn\.qkv\.bias$", 0, 3, "heads"),
    # attention out-proj (D, D) columns in (heads, head_dim) order — shard heads
    (r"attn\.proj\.weight$", 1, 1, "heads"),
    # MLP: fc1 (mlp, D) shard mlp; fc2 (D, mlp) shard mlp
    (r"mlp\.fc1\.weight$", 0, 1, "rows"),
    (r"mlp\.fc1\.bias$", 0, 1, "rows"),
    (r"mlp\.fc2\.weight$", 1, 1, "rows"),
    # classifier head (C, D) — shard the big label axis
    (r"^head\.weight$", 0, 1, "rows"),
    (r"^head\.bias$", 0, 1, "rows"),
)


def _spec_for_path(name: str, shape: tuple[int, ...], model: int, num_heads: int | None) -> Sharding:
    replicated = Sharding(spec=(None,) * len(shape))
    for pattern, dim, outer, unit in _VIT_RULES:
        if not re.search(pattern, name) or dim >= len(shape):
            continue
        if unit == "heads":
            if num_heads is None:
                return replicated  # the head boundaries are unknown
            units = num_heads
        else:
            units = shape[dim] // outer
        if shape[dim] % (outer * units) or units % model:
            return replicated  # not divisible: replicate (less parallel, still right)
        spec = tuple(MODEL_AXIS if d == dim else None for d in range(len(shape)))
        return Sharding(spec=spec, outer=outer, units=units)
    return replicated


def shard_params(params: Mapping[str, torch.Tensor], mesh: Mesh, *, num_heads: int | None = None) -> dict[str, Sharding]:
    """:class:`Sharding` of every tensor of a ViT state dict under ``mesh``.

    A rule only applies when its partitioned units divide the model axis
    (``num_heads`` gives the head count, which the qkv and out-proj rules
    need); otherwise that tensor is replicated (small models on big meshes
    stay correct, just less parallel)."""
    model = mesh.shape[MODEL_AXIS]
    return {name: _spec_for_path(name, tuple(t.shape), model, num_heads) for name, t in params.items()}


def shard_batch(batch: torch.Tensor, mesh: Mesh) -> list[torch.Tensor]:
    """Batch arrays: the leading axis split into one contiguous block a data
    row, each on its row's first entry (which drives the row's other entries).
    The leading axis must divide the data axis (callers pad)."""
    rows = mesh.local_devices[:, 0]
    if batch.shape[0] % len(rows):
        raise ValueError(f"batch of {batch.shape[0]} does not split over {len(rows)} data rows")
    return [chunk.to(dev) for chunk, dev in zip(torch.tensor_split(batch, len(rows)), rows)]


def replicated(tensor: torch.Tensor, mesh: Mesh) -> list[torch.Tensor]:
    """A copy of ``tensor`` on every mesh entry, in the grid's row-major order."""
    return [tensor.to(dev) for dev in mesh.local_devices.flat]


def place_params(
    params: Mapping[str, torch.Tensor], mesh: Mesh, *, num_heads: int | None = None
) -> list[list[dict[str, torch.Tensor]]]:
    """Place a state dict by the sharding rules: ``placed[r][m]`` is mesh
    entry (r, m)'s state dict, each tensor on that entry's device (its model
    shard where a rule applies, a copy otherwise)."""
    grid = mesh.local_devices
    model = grid.shape[1]
    shardings = shard_params(params, mesh, num_heads=num_heads)
    parts = [{name: shardings[name].shard(t, m, model) for name, t in params.items()} for m in range(model)]
    return [
        [{name: t.to(grid[r, m]) for name, t in parts[m].items()} for m in range(model)]
        for r in range(grid.shape[0])
    ]


def gather_params(
    rows: Sequence[Sequence[Mapping[str, torch.Tensor]]],
    mesh: Mesh,
    *,
    num_heads: int | None = None,
    shapes: Mapping[str, Sequence[int]],
) -> dict[str, torch.Tensor]:
    """The whole state dict from per-entry ones laid out as :func:`place_params`
    lays them (``rows[r][m]``), on entry (0, 0)'s device: a sharded tensor is
    its model entries' parts of data row 0 joined along its :class:`Sharding`
    (qkv rows back in timm's (3, heads, head_dim) order), a replicated one is
    entry (0, 0)'s copy. ``shapes`` gives each whole tensor's shape, which
    decides its :class:`Sharding` as in :func:`place_params`: a shard of a
    split tensor and a tensor its rule left whole can have the same shape.
    A name that a rule shards must be in every entry of row 0; a replicated
    one only in entry (0, 0) (the gradients of a step: copies that no forward
    reads have none)."""
    model = mesh.shape[MODEL_AXIS]
    row = rows[0]
    out = {}
    for name, shape in shapes.items():
        sharding = _spec_for_path(name, tuple(shape), model, num_heads)
        out[name] = sharding.gather([row[0][name]] if sharding.replicated else [e[name] for e in row])
    return out
