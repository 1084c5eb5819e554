"""Production and host meshes as ``DeviceMesh``es.

Port of ``repro/launch/mesh.py``. Defined as FUNCTIONS, not module-level
constants: importing this module touches no process-group state.

A ``DeviceMesh`` needs a default process group. The production meshes
(256 or 512 ranks) are built in ONE process on PyTorch's ``fake`` backend,
whose collectives do nothing: enough for placements and local shapes, the
dry-run's whole need. The host mesh is a real one-rank group (gloo on the
CPU, NCCL on a card). Every rendezvous goes through an in-process store
(``FakeStore``/``HashStore``), never ``env://``, so no port is opened and
processes side by side cannot collide. The context managers
``production_mesh`` and ``host_mesh`` create the group and always destroy
it; the ``make_*`` functions leave that to the caller
(``torch.distributed.destroy_process_group``).
"""
from __future__ import annotations

import contextlib
import math
from typing import Iterator, Tuple, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

SINGLE = ((16, 16), ("data", "model"))
MULTI = ((2, 16, 16), ("pod", "data", "model"))
HOST = ((1, 1), ("data", "model"))


def _mesh(backend: str, store, device_type: str, shape: Tuple[int, ...],
          axes: Tuple[str, ...], **kwargs) -> DeviceMesh:
    """A one-process group of ``backend`` over ``prod(shape)`` ranks and the
    mesh on it; the group is destroyed again if the mesh cannot be built."""
    if dist.is_initialized():
        raise RuntimeError("a default process group exists already; destroy it first "
                           "(torch.distributed.destroy_process_group)")
    dist.init_process_group(backend, store=store, rank=0, world_size=math.prod(shape),
                            **kwargs)
    try:
        return init_device_mesh(device_type, shape, mesh_dim_names=axes)
    except BaseException:
        dist.destroy_process_group()
        raise


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """Single pod: 256 ranks as (data=16, model=16). Multi-pod: 2 pods =
    512 ranks as (pod=2, data=16, model=16) — the ``pod`` axis is pure data
    parallelism across pods (HeMT-DP skews grain counts along it). Starts
    a one-process ``fake`` group of that world size (PyTorch's internal
    testing backend: an installation without it fails here)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    shape, axes = MULTI if multi_pod else SINGLE
    return _mesh("fake", FakeStore(), "cpu", shape, axes)


def make_host_mesh(device: Union[str, torch.device] = "cpu") -> DeviceMesh:
    """1-rank mesh with the production axis names — runs the same placed
    code paths on one CPU (gloo) or one card (NCCL)."""
    dev = torch.device(device)
    shape, axes = HOST
    if dev.type == "cuda":
        index = dev.index if dev.index is not None else torch.cuda.current_device()
        torch.cuda.set_device(index)
        return _mesh("nccl", dist.HashStore(), "cuda", shape, axes,
                     device_id=torch.device("cuda", index))
    if dev.type == "cpu":
        return _mesh("gloo", dist.HashStore(), "cpu", shape, axes)
    raise ValueError(f"host mesh on {dev}: want cpu or cuda")


@contextlib.contextmanager
def production_mesh(*, multi_pod: bool = False) -> Iterator[DeviceMesh]:
    """``make_production_mesh`` whose group is destroyed on exit."""
    mesh = make_production_mesh(multi_pod=multi_pod)
    try:
        yield mesh
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def host_mesh(device: Union[str, torch.device] = "cpu") -> Iterator[DeviceMesh]:
    """``make_host_mesh`` whose group is destroyed on exit."""
    mesh = make_host_mesh(device)
    try:
        yield mesh
    finally:
        dist.destroy_process_group()
