"""Meshes and placements, the port of `repro.launch.mesh`.

A `Mesh` is a value: named axis sizes, and the devices of this process
where it spans real ones.  `make_production_mesh` gives the reference's
16 x 16 ("data", "model") pod or its 2 x 16 x 16 ("pod", "data", "model")
pair of pods and needs no device at all: the dry-run costs steps on the
meta device against it.  `make_host_mesh` spans this process's devices.

`PartitionSpec` (`P`) and `NamedSharding` are the port's own value types,
compared by value as the JAX package's are: a spec is a tuple with one
entry a tensor dimension, each entry None, a mesh axis name or a tuple of
names (a tuple of one name is that name, an empty one None, as in JAX).

On real devices a mesh becomes a `torch.distributed` `DeviceMesh` only
when something needs one (`device_mesh`: the elastic restore, the
compressed cross-pod sum), built over the default process group, which
must then hold one rank per device of the mesh.
"""
from __future__ import annotations

import dataclasses
import math
import socket
from typing import Any, NamedTuple

import torch

from repro_torch._device import resolve_device


def _entry(e):
    if isinstance(e, (tuple, list)):
        e = tuple(e)
        if not e:
            return None
        return e[0] if len(e) == 1 else e
    return e


class PartitionSpec(tuple):
    """Per tensor dimension: None (replicated), a mesh axis name, or a tuple
    of names the dimension is split over (outermost first)."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(_entry(e) for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"

    def axes(self) -> tuple:
        """Every mesh axis the spec uses, in order."""
        out: list = []
        for e in self:
            if e is not None:
                out.extend((e,) if isinstance(e, str) else e)
        return tuple(out)


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class Mesh:
    axis_sizes: tuple
    axis_names: tuple
    #: the devices of this process, row-major over the axes; () for a mesh
    #: no process holds (the production meshes of the dry-run)
    devices: tuple = ()

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)

    @property
    def device_type(self) -> str:
        return self.devices[0].type if self.devices else "meta"

    def split(self, spec: PartitionSpec) -> int:
        """How many ways `spec` splits a tensor over this mesh."""
        return math.prod(self.shape[a] for a in spec.axes())

    def placements(self, spec: PartitionSpec) -> tuple:
        """The DTensor placements of `spec`, one per mesh axis: Shard(d)
        where the axis splits dimension d, else Replicate()."""
        from torch.distributed.tensor import Replicate, Shard
        out = []
        for name in self.axis_names:
            dims = [d for d, e in enumerate(spec) if e is not None
                    and name in ((e,) if isinstance(e, str) else e)]
            out.append(Shard(dims[0]) if dims else Replicate())
        return tuple(out)

    def device_mesh(self):
        """This mesh as a `DeviceMesh` over the default process group, which
        must hold one rank per device of the mesh; a process with no group
        starts a group of one over localhost."""
        from torch.distributed.device_mesh import DeviceMesh
        if not self.devices:
            raise ValueError(f"mesh {self.shape} spans no device of this "
                             f"process")
        world = _ensure_process_group()
        if world != self.size:
            raise ValueError(f"mesh {self.shape} needs {self.size} ranks; "
                             f"the process group has {world}")
        return DeviceMesh(self.device_type,
                          torch.arange(world).reshape(self.axis_sizes),
                          mesh_dim_names=self.axis_names)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh; as in JAX, each mesh axis splits at most one
    dimension, and only the mesh's axes may be named."""
    mesh: Mesh
    spec: PartitionSpec

    def __post_init__(self):
        axes = self.spec.axes()
        if len(set(axes)) != len(axes):
            raise ValueError(f"{self.spec} maps a mesh axis to more than "
                             f"one dimension")
        unknown = set(axes) - set(self.mesh.axis_names)
        if unknown:
            raise ValueError(f"{self.spec} names axes {sorted(unknown)} "
                             f"that mesh {self.mesh.shape} does not have")


class Placed(NamedTuple):
    """A value (a meta tensor in the dry-run) and where it is placed."""
    value: Any
    sharding: NamedSharding

    @property
    def shape(self) -> tuple:
        return tuple(self.value.shape)

    @property
    def dtype(self):
        return self.value.dtype


def map_tree(fn, tree, *rest):
    """fn over the leaves of nested dicts, lists, tuples and NamedTuples
    (a `Placed` and a `PartitionSpec` are leaves), zipped with the same
    positions of `rest`."""
    if isinstance(tree, (Placed, PartitionSpec)) or \
            not isinstance(tree, (dict, list, tuple)):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    items = [map_tree(fn, v, *(r[i] for r in rest))
             for i, v in enumerate(tree)]
    if isinstance(tree, list):
        return items
    return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)


def values(tree):
    """The values of a tree of `Placed`."""
    return map_tree(lambda p: p.value, tree)


def specs(tree):
    """The PartitionSpecs of a tree of `Placed`."""
    return map_tree(lambda p: p.sharding.spec, tree)


def shardings(mesh: Mesh, spec_tree):
    """A tree of PartitionSpecs as NamedShardings on `mesh` (the
    `shardings=` of `train.checkpoint.restore`)."""
    return map_tree(lambda spec: NamedSharding(mesh, spec), spec_tree)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _ensure_process_group() -> int:
    """The default process group's world size; where there is none, a
    group of one rank (gloo, over a free localhost port) is started."""
    import torch.distributed as dist
    if not dist.is_initialized():
        dist.init_process_group("gloo",
                                init_method=f"tcp://localhost:{_free_port()}",
                                world_size=1, rank=0)
    return dist.get_world_size()


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes)


def batch_axes(multi_pod: bool = False):
    return ("pod", "data") if multi_pod else ("data",)


def make_host_mesh(device: str | torch.device = "cuda") -> Mesh:
    """(n, 1) ("data", "model") over this process's n cards, or over one
    CPU with `device="cpu"`; raises without a card unless the CPU is
    asked for."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        devs = tuple(torch.device("cuda", i)
                     for i in range(torch.cuda.device_count()))
    elif dev.type == "cpu":
        devs = (dev,)
    else:
        raise ValueError(f"a host mesh spans real devices, not {dev}")
    return Mesh((len(devs), 1), ("data", "model"), devs)
