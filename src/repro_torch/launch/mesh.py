"""Mesh construction for the port: ``torch.distributed`` device meshes in
the JAX package's layouts (``repro.launch.mesh``).

The production layouts are the JAX package's — (16, 16) ``("data",
"model")`` for one 256-device pod, (2, 16, 16) ``("pod", "data",
"model")`` for two — kept so that every sharding decision of the port can
be held against the JAX package's leaf for leaf. They are built over the
default process group, which the dry run creates with the ``fake`` backend
(``init_process_group("fake", store=FakeStore(), world_size=256|512)``,
the counterpart of ``--xla_force_host_platform_device_count=512``): rank 0
stands for every device, and collectives return at once.

Functions, not module-level constants, so importing this module touches no
process group.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def _device_type() -> str:
    return "cuda" if torch.cuda.is_available() else "cpu"


def make_production_mesh(*, multi_pod: bool = False, device_type=None):
    """16×16 = one 256-device pod; (2, 16, 16) = two pods. The default
    process group must hold 256 (or 512) ranks."""
    shape, axes = PRODUCTION[multi_pod]
    return init_device_mesh(device_type or _device_type(), shape,
                            mesh_dim_names=axes)


def make_submesh(chips: int, *, model_axis: int = None, device_type=None):
    """A (data, model) mesh over the first ``chips`` ranks of the default
    group — the spatial-multiplexing unit: one D-STACK allocation = one
    sub-mesh."""
    if model_axis is None:
        model_axis = min(chips, 16)
    data_axis = max(1, chips // model_axis)
    ranks = torch.arange(data_axis * model_axis).reshape(data_axis,
                                                         model_axis)
    return DeviceMesh(device_type or _device_type(), ranks,
                      mesh_dim_names=("data", "model"))


def make_cpu_mesh():
    """Single-device (1, 1) mesh for smoke tests (on the card: the card's
    1×1 mesh). Needs a default process group of one rank."""
    if not dist.is_initialized():
        raise RuntimeError("make_cpu_mesh needs a process group of one "
                           "rank (init_process_group first)")
    return init_device_mesh(_device_type(), (1, 1),
                            mesh_dim_names=("data", "model"))
