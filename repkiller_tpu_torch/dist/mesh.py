"""The (data, shard) device mesh of the sharded backend (counterpart of
repkiller_tpu/dist/mesh.py).

One mesh, two axes, as in the reference:

- ``"data"``: query windows of the X genome; window d owns seed start
  positions [d*win, (d+1)*win).
- ``"shard"``: k-mer hash-prefix shards of the index; shard s owns the
  k-mers whose top bits equal s, so a k-mer's whole occurrence run lives in
  one shard and per-shard hit sets partition the global hit set.

torch has no ``shard_map``. The sharded pipeline is written as per-(d, s)
*body* functions, split at every collective, and a mesh runs them: a
:class:`Mesh` holds the bodies this process runs and the two collectives
the reference uses (all-to-all and all-gather along either axis). Values
that differ per body travel as dicts ``{(d, s): tensor}``. Two meshes:

- :class:`LocalMesh`: one process holds every body, each on its own
  ``torch.device`` (a device may repeat: ``["cpu"] * 8`` stands for the
  reference's 8 virtual CPU devices, ``["cuda:0"] * 4`` is four bodies on
  one card, run one after another). The collectives are list
  transposition and concatenation, with ``.to(device)`` between bodies.
- :class:`ProcessMesh`: one body per ``torch.distributed`` rank, rank =
  d * n_shard + s; the collectives are ``all_to_all_single`` and the list
  form of ``all_gather`` over per-axis subgroups.

The pipeline runs stage by stage: every body's part up to a collective, the
collective, then every body's next part.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..device import check_device
from ..utils import trace

DATA_AXIS = "data"
SHARD_AXIS = "shard"

Body = Tuple[int, int]


def process_group_active() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank_device(device="cuda") -> torch.device:
    """This rank's device of type ``device``: a CUDA rank takes card
    rank % device_count unless ``device`` names one."""
    dev = check_device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", dist.get_rank() % torch.cuda.device_count())
    return dev


def default_devices(device="cuda") -> list:
    """Counterpart of ``jax.devices()`` outside a process group: every
    visible CUDA device for ``"cuda"``, else the one device named."""
    dev = check_device(device)
    if dev.type == "cuda" and dev.index is None:
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [dev]


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, *,
                     device="cuda") -> None:
    """Join the process group of a multi-process run: one rank per process,
    ``nccl`` when the rank's device is CUDA and ``gloo`` on the CPU, through
    ``tcp://{coordinator}``. A no-op for one process or none."""
    if num_processes is None or num_processes <= 1:
        return
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)
    if backend == "nccl":
        torch.cuda.set_device(rank_device(device))


class Mesh:
    """A (data, shard) mesh: its shape and the bodies this process runs,
    each with its device."""

    def __init__(self, n_data: int, n_shard: int, devices: Dict[Body, torch.device]):
        self.n_data, self.n_shard = n_data, n_shard
        self.devices = devices
        self.bodies = list(devices)

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.n_data, SHARD_AXIS: self.n_shard}

    @property
    def size(self) -> int:
        return self.n_data * self.n_shard

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.n_data}x{self.n_shard})"

    def map(self, fn: Callable, *per_body: dict) -> dict:
        """{body: fn(body, *(v[body] for v in per_body))} over this
        process's bodies."""
        return {b: fn(b, *(v[b] for v in per_body)) for b in self.bodies}

    def replicate(self, arr) -> dict:
        """The same array (numpy or tensor) on every body's device, one
        copy per distinct device."""
        t = torch.from_numpy(arr.copy()) if isinstance(arr, np.ndarray) else arr
        copies = {}
        for dev in self.devices.values():
            if dev not in copies:
                copies[dev] = t.to(dev)
        return {b: copies[dev] for b, dev in self.devices.items()}

    def all_to_all(self, vals: dict, axis: str) -> dict:
        """Tiled all-to-all along ``axis`` over dim 0: a body splits its
        tensor into as many equal blocks as the axis has bodies and sends
        block j to the body at axis index j; it receives one block from
        each, concatenated in axis order."""
        raise NotImplementedError

    def all_gather(self, vals: dict, axis: str, tiled: bool = True) -> dict:
        """Every body's tensor along ``axis``, in axis order, concatenated
        over dim 0 (tiled) or stacked on a new leading dim."""
        raise NotImplementedError

    def gather_counts(self, vals: dict) -> np.ndarray:
        """Every body's 1-D int64 tensor of counters, on every process ->
        (n_data * n_shard, m) numpy rows in body order (d, s)."""
        raise NotImplementedError


def _count_bytes(vals: dict) -> None:
    """The bytes handed to a collective, from the shapes: the trace's
    ``collective_bytes``."""
    trace.count("collective_bytes", sum(v.nbytes for v in vals.values()))


def _axis_index(body: Body, axis: str) -> int:
    return body[0] if axis == DATA_AXIS else body[1]


class LocalMesh(Mesh):
    """Every body in this process; collectives move tensors between the
    bodies' devices."""

    def __init__(self, n_data: int, n_shard: int, devices: Sequence):
        super().__init__(n_data, n_shard, {
            (d, s): torch.device(devices[d * n_shard + s])
            for d in range(n_data) for s in range(n_shard)})

    def _peers(self, body: Body, axis: str) -> list:
        d, s = body
        if axis == DATA_AXIS:
            return [(j, s) for j in range(self.n_data)]
        return [(d, j) for j in range(self.n_shard)]

    def all_to_all(self, vals: dict, axis: str) -> dict:
        _count_bytes(vals)
        out = {}
        for b in self.bodies:
            peers = self._peers(b, axis)
            i = _axis_index(b, axis)
            out[b] = torch.cat([vals[p].unflatten(0, (len(peers), -1))[i]
                                .to(self.devices[b]) for p in peers])
        return out

    def all_gather(self, vals: dict, axis: str, tiled: bool = True) -> dict:
        _count_bytes(vals)
        join = torch.cat if tiled else torch.stack
        return {b: join([vals[p].to(self.devices[b])
                         for p in self._peers(b, axis)])
                for b in self.bodies}

    def gather_counts(self, vals: dict) -> np.ndarray:
        return np.stack([vals[b].cpu().numpy() for b in self.bodies])


class ProcessMesh(Mesh):
    """One body per ``torch.distributed`` rank (rank = d * n_shard + s) on
    this rank's ``device``. Every rank creates every axis subgroup, in the
    same order. Bool tensors travel as int8."""

    def __init__(self, n_data: int, n_shard: int, device: torch.device):
        rank = dist.get_rank()
        me = (rank // n_shard, rank % n_shard)
        super().__init__(n_data, n_shard, {me: torch.device(device)})
        self.me = me
        self.groups = {}
        for s in range(n_shard):
            g = dist.new_group([d * n_shard + s for d in range(n_data)])
            if s == me[1]:
                self.groups[DATA_AXIS] = g
        for d in range(n_data):
            g = dist.new_group([d * n_shard + s for s in range(n_shard)])
            if d == me[0]:
                self.groups[SHARD_AXIS] = g

    def all_to_all(self, vals: dict, axis: str) -> dict:
        _count_bytes(vals)
        x = vals[self.me]
        send = x.to(torch.int8) if x.dtype == torch.bool else x.contiguous()
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=self.groups[axis])
        return {self.me: recv.to(x.dtype)}

    def all_gather(self, vals: dict, axis: str, tiled: bool = True) -> dict:
        _count_bytes(vals)
        x = vals[self.me]
        send = x.to(torch.int8) if x.dtype == torch.bool else x.contiguous()
        n = self.n_data if axis == DATA_AXIS else self.n_shard
        parts = [torch.empty_like(send) for _ in range(n)]
        dist.all_gather(parts, send, group=self.groups[axis])
        join = torch.cat if tiled else torch.stack
        return {self.me: join(parts).to(x.dtype)}

    def gather_counts(self, vals: dict) -> np.ndarray:
        x = vals[self.me].to(torch.int64)
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, x)
        return torch.stack(parts).cpu().numpy()


def make_mesh(n_data: Optional[int] = None, n_shard: Optional[int] = None,
              devices: Optional[Sequence] = None, *, device="cuda") -> Mesh:
    """Mesh with axes (data, shard) over ``devices``: with none given, a
    :class:`ProcessMesh` over the ranks of an active process group (one
    body each, on this rank's device of type ``device``), else a
    :class:`LocalMesh` over :func:`default_devices`.

    n_shard must be a power of two (k-mer prefix ownership); it defaults
    to the largest power of two <= sqrt(n) so both axes scale. A mesh
    smaller than the device list takes the leading devices."""
    grouped = devices is None and process_group_active()
    if grouped:
        n = dist.get_world_size()
    else:
        devs = list(devices) if devices is not None else default_devices(device)
        n = len(devs)
    if n_shard is None and n_data is None:
        n_shard = 1 << (max(1, int(np.sqrt(n))).bit_length() - 1)
        n_data = n // n_shard
    elif n_shard is None:
        n_shard = n // n_data
    elif n_data is None:
        n_data = n // n_shard
    if n_data * n_shard > n:
        raise ValueError(f"{n_data}x{n_shard} mesh > {n} devices")
    if n_shard & (n_shard - 1):
        raise ValueError(f"n_shard must be a power of two, got {n_shard}")
    if grouped:
        if n_data * n_shard != n:
            raise ValueError(f"{n_data}x{n_shard} mesh < {n} processes: each "
                             "rank holds one (data, shard) body")
        return ProcessMesh(n_data, n_shard, rank_device(device))
    return LocalMesh(n_data, n_shard, devs[: n_data * n_shard])
