"""Device meshes and the multi-process hook.

The port's copy of ``delivr_cfos_tpu/parallel/mesh.py``. The reference's only
device parallelism is single-node ``torch.nn.DataParallel`` (reference:
inference/inference.py:217-219). The JAX package drives several chips from
one process through ``shard_map`` over a ``jax.sharding.Mesh``; the port keeps
that single-controller design: a ``Mesh`` is an array of ``torch.device``s
with named axes, one process runs every shard of it, and halo planes move
between the shards' devices as device-to-device copies (peer to peer over
NVLink where the cards have it). Several processes, each serving its own
brains, join through ``torch.distributed`` (``maybe_initialize_distributed``),
as the JAX package's hosts join through ``jax.distributed``.

A mesh may name one device several times: ``make_mesh({"sp": 4},
devices=["cuda:0"] * 4)`` runs four shards, their halo exchange included, on
one card, and ``["cpu"] * 8`` is the CPU tests' mesh, the counterpart of the
JAX tests' eight virtual CPU devices.
"""

from __future__ import annotations

import os

import numpy as np
import torch


class Mesh:
    """``devices``: an ndarray of ``torch.device`` with one dimension per
    axis; ``axis_names``: their names. ``shape`` maps each name to its size,
    as ``jax.sharding.Mesh.shape`` does."""

    def __init__(self, devices, axis_names):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"{self.devices.ndim}-d devices for axes {self.axis_names}")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    def axis_devices(self, axis: str) -> list:
        """The devices of the shards along ``axis`` (the first index of every
        other axis: the port runs one replica of a shard's work, where
        ``shard_map`` repeats it over the other axes)."""
        d = np.moveaxis(self.devices, self.axis_names.index(axis), 0)
        return list(d.reshape(d.shape[0], -1)[:, 0])


def _device_array(devices, shape) -> np.ndarray:
    arr = np.empty(len(devices), dtype=object)
    arr[:] = [torch.device(d) for d in devices]
    return arr.reshape(shape)


def visible_devices(device=None) -> list:
    """The devices one process may spread work over: every visible CUDA
    device (``device`` None or CUDA), else ``[device]``. Raises where CUDA is
    asked for and there is none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return [dev]
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass the devices to use")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(axis_sizes: dict | None = None, devices=None) -> Mesh:
    """A mesh from {axis_name: size} over ``devices`` (default: every
    visible CUDA device on one 'sp' axis; raises without CUDA). The sizes
    must multiply to at most the device count; the first that many devices
    are used. ``devices`` may repeat a device (the one-card and CPU meshes)."""
    if devices is None:
        devices = visible_devices()
    if axis_sizes is None:
        axis_sizes = {"sp": len(devices)}
    sizes = tuple(axis_sizes.values())
    n = int(np.prod(sizes))
    if n > len(devices):
        raise ValueError(f"mesh needs {n} devices, have {len(devices)}")
    return Mesh(_device_array(list(devices)[:n], sizes), axis_sizes.keys())


def make_hybrid_mesh(dcn_axis: str = "dp", ici_axis: str = "sp",
                     n_slices: int | None = None, devices=None) -> Mesh:
    """A (slices, devices per slice) mesh, the slice axis outermost: brains
    are distributed over slices, each brain's spatial sharding stays inside
    one slice. The port discovers no slice topology, so this is the logical
    reshape the JAX package makes on its CPU meshes: ``n_slices`` rows where
    they divide the devices, else one."""
    if devices is None:
        devices = visible_devices()
    n = len(devices)
    rows = n_slices if n_slices and n_slices > 1 and n % n_slices == 0 else 1
    return Mesh(_device_array(list(devices), (rows, n // rows)), (dcn_axis, ici_axis))


def slice_submeshes(mesh: Mesh, ici_axis: str = "sp") -> list:
    """One single-axis mesh per slice (row) of a hybrid mesh."""
    devs = mesh.devices if mesh.devices.ndim > 1 else mesh.devices[None]
    return [Mesh(devs[i], (ici_axis,)) for i in range(devs.shape[0])]


def assign_brains_to_slices(n_brains: int, n_slices: int) -> list:
    """Round-robin brain → slice assignment: per-slice brain index lists.
    With several processes each serves the slice of its rank; one process
    serves every slice."""
    out = [[] for _ in range(n_slices)]
    for i in range(n_brains):
        out[i % n_slices].append(i)
    return out


def maybe_initialize_distributed(env: dict | None = None) -> bool:
    """Join a ``torch.distributed`` process group when a multi-process
    launch is detected; the counterpart of the JAX package's
    ``jax.distributed.initialize`` hook.

    Detection, in order:
    - ``DELIVR_DISTRIBUTED=0`` disables unconditionally;
    - a process group already initialized: nothing to do;
    - ``DELIVR_COORDINATOR`` (host:port, with ``DELIVR_NUM_PROCESSES`` and
      ``DELIVR_PROCESS_ID``) gives an explicit TCP rendezvous;
    - ``DELIVR_DISTRIBUTED=1`` forces the ``env://`` rendezvous
      (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``);
    - a torchrun launch (``WORLD_SIZE`` above 1 with ``MASTER_ADDR``) joins
      its rendezvous, where the JAX package reads a TPU pod's variables.

    The group uses the gloo backend and carries no tensors: the runner reads
    its rank and world size to pick its brains, so several processes may
    share one card. Returns True when a group was initialized."""
    import torch.distributed as dist

    e = os.environ if env is None else env
    flag = e.get("DELIVR_DISTRIBUTED", "").strip()
    if flag == "0" or dist.is_initialized():
        return False
    coord = e.get("DELIVR_COORDINATOR", "").strip()
    if coord:
        kwargs = {
            "init_method": f"tcp://{coord}",
            "world_size": int(e.get("DELIVR_NUM_PROCESSES", "1")),
            "rank": int(e.get("DELIVR_PROCESS_ID", "0")),
        }
    elif flag == "1":
        kwargs = {"init_method": "env://"}
    else:
        world = int(e.get("WORLD_SIZE", "1") or 1)
        addr = e.get("MASTER_ADDR", "").strip()
        if world <= 1 or not addr:
            return False
        kwargs = {
            "init_method": f"tcp://{addr}:{e.get('MASTER_PORT', '29500')}",
            "world_size": world,
            "rank": int(e.get("RANK", "0")),
        }
    dist.init_process_group(backend="gloo", **kwargs)
    return True


def process_index() -> tuple[int, int]:
    """(rank, world size) of this process: (0, 1) without a process group."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1
