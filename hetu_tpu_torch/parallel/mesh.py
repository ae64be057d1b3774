"""The device mesh (port of ``hetu_tpu/parallel/mesh.py``, ``make_mesh``).

A ``Mesh`` names the axes of an array of devices, as ``jax.sharding.Mesh``
does for the JAX package: ``mesh.shape`` is an ``{axis: size}`` mapping in
axis order and ``mesh.devices`` the numpy array of devices.

The port's executor is single-controller, as the JAX one is: one process
holds the global tensors.  A mesh may place several of its positions on one
device (``make_mesh({"cp": 4}, devices=["cuda:0"] * 4)``, the counterpart of
the JAX tests' ``--xla_force_host_platform_device_count``).  The ops that
read a mesh then run every position's share in that process, on that
device.  A mesh over distinct devices needs a transport between them,
which arrives with the rest of slice F (ROADMAP.md); such a mesh can be
built, and the ops that would move data between its devices raise.
``DistState`` and the sharding helpers also wait for slice F.
"""

from __future__ import annotations

import math

import numpy as np
import torch


class Mesh:
    """Named axes over an array of devices."""

    def __init__(self, devices, axis_names):
        self.devices = np.asarray(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"{self.devices.ndim}-d devices for axes "
                             f"{self.axis_names}")

    @property
    def shape(self):
        return dict(zip(self.axis_names, self.devices.shape))

    def single_device(self):
        """The one device every position of the mesh sits on, or None."""
        first = self.devices.flat[0]
        return (first if all(same_device(d, first) for d in self.devices.flat)
                else None)

    def __repr__(self):
        return f"Mesh({self.shape}, devices={list(self.devices.flat)})"


def _visible_devices():
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(axes, devices=None):
    """A Mesh from {'axis': size}; insertion order is the device-major
    order, as in the JAX package.

    ``devices=None`` takes the visible CUDA devices, which must hold enough
    distinct devices, as JAX's does.  An explicit ``devices`` list may
    repeat one device (``["cpu"] * 4``, ``[torch.device("cuda", 0)] * 4``):
    each entry becomes a ``torch.device``.
    """
    names = tuple(axes.keys())
    sizes = tuple(int(s) for s in axes.values())
    n = math.prod(sizes)
    if devices is None:
        devices = _visible_devices()
    devices = [torch.device(d) for d in devices]
    assert n <= len(devices), \
        f"mesh {axes} needs {n} devices, have {len(devices)}"
    grid = np.empty(n, dtype=object)
    grid[:] = devices[:n]
    return Mesh(grid.reshape(sizes), names)


def same_device(a, b) -> bool:
    """Whether two devices are one; a CUDA device without an index matches
    any CUDA index (``"cuda"`` names the current one)."""
    a, b = torch.device(a), torch.device(b)
    return a.type == b.type and (a.index is None or b.index is None
                                 or a.index == b.index)


def mesh_device(mesh, what):
    """The one device of a port ``Mesh`` whose positions share it; any
    other mesh raises, naming the transport it would need."""
    single = getattr(mesh, "single_device", None)
    dev = single() if callable(single) else None
    if dev is None:
        raise NotImplementedError(
            f"{what} runs a Mesh whose positions share one device "
            "(make_mesh(axes, devices=[device] * n)); a mesh over distinct "
            f"devices ({mesh!r}) needs the multi-device transport of slice "
            "F (ROADMAP.md)")
    return dev
