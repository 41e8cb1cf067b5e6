"""Meshes: the serving and pruning meshes over this host's devices, and
the production mesh the cells are built for.

Counterpart of ``repro.launch.mesh`` (``make_production_mesh``,
``make_host_mesh``, ``make_serve_mesh``, ``default_serve_hosts``).  A :class:`Mesh` is named
axes over an array of ``torch.device`` s; one process drives every
device of it (the reference's single controller): each shard's work is
launched on its own device, and a shard's results are copied to the
root device.  A mesh may repeat a device — the counterpart of the
reference's ``--xla_force_host_platform_device_count``, used by the
tests (four or eight CPU positions) and by ``chip_smoke.py`` on one
card.  The steps that run over a mesh's positions are the a2a lookup
(``models.recsys.alltoall_lookup``) and the placed LM train step
(``sharding.placed.placed_step``).

The CLI builds its meshes from :func:`local_devices` alone, which never
repeats a device; the ``devices=`` argument of the mesh functions is for
tests and the smoke script.  :func:`make_production_mesh` is the
reference's 16 x 16 (or 2 x 16 x 16) pod; the dry run
(``launch.dryrun``) builds it over 256 or 512 ``meta`` positions.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["Mesh", "default_serve_hosts", "local_devices", "make_host_mesh",
           "make_production_mesh", "make_serve_mesh"]


class Mesh:
    """Named axes over a ``shape``-d array of devices.  ``shape`` maps
    each axis name to its size, as the reference's mesh does; two meshes
    are equal when their axes, shape and devices are."""

    def __init__(self, devices, axis_names, shape=None):
        flat = [torch.device(d) for d in devices]
        self.axis_names = tuple(axis_names)
        shape = tuple(shape) if shape is not None else (len(flat),)
        if len(shape) != len(self.axis_names) or int(np.prod(shape)) != len(
                flat):
            raise ValueError(f"{len(flat)} devices in shape {shape} for "
                             f"axes {self.axis_names}")
        arr = np.empty(len(flat), dtype=object)
        arr[:] = flat
        self.devices = arr.reshape(shape)
        self._key = (self.axis_names, shape, tuple(str(d) for d in flat))

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    def devices_along(self, axes, **at) -> list:
        """The devices along ``axes`` (in mesh order), the other axes
        at the index ``at`` names (0 by default)."""
        idx = tuple(slice(None) if a in axes else at.get(a, 0)
                    for a in self.axis_names)
        return list(self.devices[idx].reshape(-1))

    def distinct(self) -> int:
        return len(set(self.devices.reshape(-1)))

    def __eq__(self, other):
        return isinstance(other, Mesh) and self._key == other._key

    def __hash__(self):
        return hash(self._key)

    def __repr__(self):
        devs = ",".join(str(d) for d in self.devices.reshape(-1))
        return f"Mesh({self.shape}, [{devs}])"


def local_devices(device=None) -> list:
    """The devices this host serves on: every CUDA card for a ``cuda``
    device (the default), the CPU alone for ``cpu``.  The CLI's only
    source of devices; never repeats one."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


def _devices(devices) -> list:
    devs = list(local_devices() if devices is None else devices)
    if not devs:
        raise RuntimeError("no device to build a mesh over")
    return devs


def make_production_mesh(*, multi_pod: bool = False, devices=None) -> Mesh:
    """The production pod: ``(16, 16)`` over ``("data", "model")``, or
    with ``multi_pod`` ``(2, 16, 16)`` over ``("pod", "data",
    "model")``.  ``devices`` (default: this host's) fill the 256 or 512
    positions in turn, repeating as they must."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    devs = _devices(devices)
    n = int(np.prod(shape))
    return Mesh([devs[i % len(devs)] for i in range(n)], axes, shape)


def make_host_mesh(devices=None) -> Mesh:
    """Every device on ``data`` (a ``(n, 1)`` ``data x model`` mesh):
    the sharded pruning mesh."""
    devs = _devices(devices)
    return Mesh(devs, ("data", "model"), (len(devs), 1))


def make_serve_mesh(hosts: int = 1, devices=None) -> Mesh:
    """``hosts=1``: the flat host mesh, every device on ``model`` (the
    axis ``sharding.serve_rules`` shards the corpus doc axis over).
    ``hosts > 1``: the ``hosts x candidates`` grid, one row of devices a
    host group; the device count must divide into ``hosts`` rows."""
    devs = _devices(devices)
    n = len(devs)
    if hosts <= 1:
        return Mesh(devs, ("data", "model"), (1, n))
    if n % hosts:
        raise ValueError(
            f"make_serve_mesh(hosts={hosts}): {n} devices do not divide "
            f"into {hosts} host groups")
    return Mesh(devs, ("hosts", "candidates"), (hosts, n // hosts))


def default_serve_hosts(devices=None) -> int:
    """The host-group count of ``--mesh grid``: the largest power of two
    ``h`` with ``h * h <= n_devices`` that divides the device count (4
    devices: a 2 x 2 grid; 1-2 devices: 1, the flat mesh)."""
    n = len(_devices(devices))
    h = 1
    while 2 * h * (2 * h) <= n and n % (2 * h) == 0:
        h *= 2
    return h
