"""Process groups and data-parallel helpers (port of
``sisr_tpu/parallel/mesh.py``).

JAX runs one program over a device mesh: the batch is sharded on the
``data`` axis, parameters are replicated, and XLA inserts the gradient
all-reduce.  PyTorch runs one process per device.  Here a ``Mesh`` is this
process's view of a 1-D group: its size, its rank and its device.  The
collectives are written out where XLA would insert them:

  * ``initialize_distributed`` joins the group (a launcher's environment,
    or explicit arguments) and makes this rank's card the current device
    before any collective;
  * ``shard_batch`` takes this rank's contiguous slice of a batch, as
    ``PartitionSpec("data")`` assigns it;
  * ``replicate`` broadcasts rank 0's parameters, buffers and optimizer
    state (or any picklable value);
  * ``all_reduce_grads`` sums the gradients over the ranks and divides by
    the group's size: the gradient of the global batch's mean loss;
  * ``process_zero`` guards file writes (BasicSR's ``master_only``);
  * ``spawn`` runs a function in N fresh ranks over a ``file://`` store.

Only ``all_reduce``, ``broadcast`` and ``barrier`` are used: gloo offers
no more for CUDA tensors, and gloo is what runs two ranks on one card (NCCL
refuses two ranks on one device).  Without a process group a mesh has one
rank and every collective is skipped.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time
from dataclasses import dataclass
from datetime import timedelta
from typing import Any, Callable, Dict, Iterable, List, Optional

import torch
import torch.distributed as dist
from torch import nn

# this process's device, as initialize_distributed chose it (the process
# group itself is process-wide state of torch.distributed)
_device: Dict[str, Optional[torch.device]] = {"device": None}


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh seen from one rank.  ``group`` is None when no process
    group is initialized: one rank, and no collective runs."""

    axis_name: str
    size: int
    rank: int
    device: torch.device
    group: Any = None


def initialize_distributed(init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None,
                           backend: Optional[str] = None,
                           device=None,
                           timeout: float = 600.0) -> torch.device:
    """Join the process group; returns this rank's device.

    With no ``init_method`` it reads a launcher's environment (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``, as
    torchrun sets them): the counterpart of JAX's pod discovery.  Explicit
    arguments serve manual launches; a ``file://`` store needs no port.
    ``device`` defaults to ``cuda:{LOCAL_RANK}`` (``cuda:{rank}`` when
    ``LOCAL_RANK`` is unset) and becomes the current CUDA device before any
    collective.  ``backend`` defaults to nccl for a CUDA device and gloo
    for the CPU.  ``timeout`` (seconds) bounds the rendezvous and every
    collective."""
    if init_method is None:
        init_method = "env://"
        rank = int(os.environ["RANK"]) if rank is None else rank
        world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else world_size
    elif world_size is None or rank is None:
        raise ValueError("an explicit init_method needs world_size and rank")
    if device is None:
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', rank))}"
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"no CUDA card for {device}: pass device='cpu' for a CPU group")
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank, timeout=timedelta(seconds=timeout))
    _device["device"] = device
    return device


def _group_device() -> torch.device:
    """The device of this rank in a group that initialize_distributed did
    not start: the current card under nccl, else the CPU."""
    if _device["device"] is not None:
        return _device["device"]
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "data",
              device=None) -> Mesh:
    """The mesh of the initialized group; raises if its size is not
    ``n_devices``.  Without a group: a one-rank mesh on ``device``
    (default ``cuda``), or a raise when ``n_devices`` asks for more."""
    if dist.is_available() and dist.is_initialized():
        size = dist.get_world_size()
        if n_devices is not None and n_devices != size:
            raise ValueError(f"the process group has {size} ranks, not n_devices={n_devices}")
        mine = _group_device()
        if device is not None and torch.device(device).type != mine.type:
            raise ValueError(f"this rank's device is {mine}, not {device}")
        return Mesh(axis_name, size, dist.get_rank(), mine, dist.group.WORLD)
    if n_devices is not None and n_devices > 1:
        raise RuntimeError(f"n_devices={n_devices} needs a process group: launch one process "
                           "per device (torchrun --nproc-per-node N, or mesh.spawn) and call "
                           "initialize_distributed() in each before building the mesh")
    return Mesh(axis_name, 1, 0, torch.device("cuda" if device is None else device))


def process_zero() -> bool:
    """Rank-0 guard for I/O; true without a process group."""
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def shard_batch(mesh: Mesh, batch):
    """This rank's contiguous slice of the batch dimension of an array or
    tensor (or a tuple or list of them)."""
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(mesh, b) for b in batch)
    n = batch.shape[0]
    if n % mesh.size:
        raise ValueError(f"a batch of {n} does not split over {mesh.size} ranks")
    per = n // mesh.size
    return batch[mesh.rank * per:(mesh.rank + 1) * per]


def _by_dtype(tensors: Iterable[torch.Tensor]) -> Dict[torch.dtype, List[torch.Tensor]]:
    out: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        out.setdefault(t.dtype, []).append(t)
    return out


def _flat(ts: List[torch.Tensor], device: torch.device) -> torch.Tensor:
    """One contiguous buffer on ``device`` of the values of ``ts`` (bool
    as uint8: collectives take bytes for it)."""
    flat = torch.cat([t.detach().reshape(-1).to(device) for t in ts])
    return flat.view(torch.uint8) if flat.dtype == torch.bool else flat


@torch.no_grad()
def _broadcast_(mesh: Mesh, tensors: Iterable[torch.Tensor]) -> None:
    """Overwrite ``tensors`` with rank 0's values: one broadcast per dtype.
    The values are written with ``copy_``, which advances each tensor's
    version counter: the packed and derived weights cached on a parameter
    (``build.cached``, ``arch_util.derived``) are keyed on it."""
    if mesh.group is None:
        return
    for ts in _by_dtype(tensors).values():
        flat = _flat(ts, mesh.device)
        dist.broadcast(flat, src=0, group=mesh.group)
        if mesh.rank == 0:
            continue
        if ts[0].dtype == torch.bool:
            flat = flat.view(torch.bool)
        for t, v in zip(ts, flat.split([t.numel() for t in ts])):
            t.copy_(v.view_as(t))


def _replicate_optimizer(mesh: Mesh, opt: torch.optim.Optimizer) -> None:
    """Rank 0's optimizer state on every rank: its layout (hyperparameters,
    which parameters have state, each tensor's shape and dtype) as one
    pickled broadcast, then its tensors."""
    sd = opt.state_dict()
    spec = lambda v: (("tensor", tuple(v.shape), v.dtype, v.device.type)
                      if torch.is_tensor(v) else ("value", v))
    layout = replicate(mesh, {"param_groups": sd["param_groups"],
                              "state": {i: {k: spec(v) for k, v in s.items()}
                                        for i, s in sd["state"].items()}})
    state, tensors = {}, []
    for i in sorted(layout["state"]):
        state[i] = {}
        for k in sorted(layout["state"][i]):
            kind, *rest = layout["state"][i][k]
            if kind == "value":
                state[i][k] = rest[0]
                continue
            shape, dtype, devtype = rest
            t = (sd["state"][i][k] if mesh.rank == 0 else
                 torch.empty(shape, dtype=dtype,
                             device=mesh.device if devtype != "cpu" else "cpu"))
            state[i][k] = t
            tensors.append(t)
    _broadcast_(mesh, tensors)
    if mesh.rank != 0:
        opt.load_state_dict({"state": state, "param_groups": layout["param_groups"]})


def replicate(mesh: Mesh, obj):
    """Rank 0's copy of ``obj`` on every rank, returned: a module's
    parameters and buffers (spectral norm's ``u``, ``v`` among them) and an
    optimizer's state are overwritten in place; any other value is
    pickled from rank 0."""
    if mesh.group is None:
        return obj
    if isinstance(obj, nn.Module):
        _broadcast_(mesh, list(obj.parameters()) + list(obj.buffers()))
    elif isinstance(obj, torch.optim.Optimizer):
        _replicate_optimizer(mesh, obj)
    else:
        box = [obj]
        dist.broadcast_object_list(box, src=0, group=mesh.group)
        obj = box[0]
    return obj


@torch.no_grad()
def all_reduce_grads(mesh: Mesh, params: Iterable[torch.Tensor]) -> None:
    """Average the gradients of ``params`` over the ranks, in place: one
    coalesced SUM per dtype, then a division by the group's size (gloo has
    no AVG).  Every rank must hold gradients for the same parameters."""
    if mesh.group is None:
        return
    grads = [p.grad for p in params if p.grad is not None]
    for gs in _by_dtype(grads).values():
        flat = _flat(gs, mesh.device)
        dist.all_reduce(flat, group=mesh.group)
        flat /= mesh.size
        for g, v in zip(gs, flat.split([g.numel() for g in gs])):
            g.copy_(v.view_as(g))


def all_reduce_sum(mesh: Mesh, tensor: torch.Tensor) -> torch.Tensor:
    """``tensor`` summed over the ranks, in place; returned."""
    if mesh.group is not None:
        dist.all_reduce(tensor, group=mesh.group)
    return tensor


def all_reduce_mean(mesh: Mesh, tensor: torch.Tensor) -> torch.Tensor:
    """The mean of ``tensor`` over the ranks, as a new tensor."""
    out = tensor.detach().clone()
    if mesh.group is None:
        return out
    dist.all_reduce(out, group=mesh.group)
    return out / mesh.size


def _spawned(rank: int, fn: Callable, n: int, init_method: str, backend: Optional[str],
             device, timeout: float, out_dir: str, args: tuple) -> None:
    """One rank of ``spawn``: join the group, run ``fn``, save its result."""
    initialize_distributed(init_method, n, rank, backend=backend,
                           device=f"cuda:{rank}" if device is None else device,
                           timeout=timeout)
    try:
        result = fn(rank, *args)
        path = os.path.join(out_dir, f"rank{rank}.pt")
        torch.save(result, path + ".tmp")
        os.replace(path + ".tmp", path)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, n_devices: int, *args, backend: Optional[str] = None,
          device=None, timeout: float = 600.0) -> list:
    """Run ``fn(rank, *args)`` in ``n_devices`` fresh processes, each in a
    group started by ``initialize_distributed`` over a new ``file://``
    store, and return their results (``torch.save``-able) in rank order.

    ``device`` is every rank's device (``"cpu"``, or ``"cuda:0"`` for ranks
    that share one card under gloo); None gives rank r ``cuda:r``.  ``fn``
    must be importable by name: the children import its module.  A rank
    that raises fails the call and ends the others; past ``timeout``
    seconds the ranks are killed and ``TimeoutError`` raised."""
    import torch.multiprocessing as tmp

    out_dir = tempfile.mkdtemp(prefix="sisr_spawn_")
    try:
        ctx = tmp.spawn(_spawned, nprocs=n_devices, join=False,
                        args=(fn, n_devices, f"file://{os.path.join(out_dir, 'store')}",
                              backend, device, timeout, out_dir, args))
        deadline = time.monotonic() + timeout
        while not ctx.join(timeout=5.0):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
                for p in ctx.processes:
                    p.join(10.0)
                raise TimeoutError(f"spawn: {n_devices} ranks did not end within {timeout} s")
        return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
                for r in range(n_devices)]
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
