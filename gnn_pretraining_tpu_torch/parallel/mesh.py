"""The data axis of the port: the ranks of a ``torch.distributed`` group.

Port of ``gnn_pretraining_tpu/parallel/mesh.py`` for its ``data`` axis, which
also serves as its ``edge`` axis (the JAX package's partitioned modes take a
mesh of one data row and n edge columns). One
JAX device on that axis is one process here, a rank of a process group;
``shard_map``'s per-device body is each rank's own code, and the JAX
collectives become these (``DataAxis``):

  * ``psum`` → ``psum``: an all-reduce whose backward all-reduces the
    gradient, as JAX transposes ``psum``;
  * ``all_gather(tiled=True)`` → ``gather_rows``: one all-reduce of a
    zero-filled ``[n·rows, ...]`` buffer in which each rank fills its own
    slice (exact: every other term is 0), rank-major as JAX's tiled gather.
    Its backward hands each rank the sum over ranks of its slice's
    gradient, n times its share of a loss that every rank computes, as
    JAX's transpose of ``all_gather`` does; the gradient ``pmean`` removes
    the factor. One collective for every backend: gloo runs all-reduce on
    CUDA tensors, and the autograd all-gather of ``torch.distributed.nn``
    takes all-to-all in its backward off NCCL;
  * ``pmean`` of the gradients → ``pmean``: one all-reduce of the leaves
    laid end to end, then a division by n;
  * ``all_to_all(x, axis, 0, 0, tiled=True)`` → ``all_to_all``: dim 0 split
    into n blocks, block q to rank q, the received blocks concatenated in
    rank order; its backward is the same exchange of the gradient, as JAX
    transposes it. It runs as ``all_to_all_single`` where the backend takes
    it (NCCL; gloo on CPU tensors); gloo refuses it on CUDA tensors, so
    there the send buffer is staged in host memory and the result copied
    back to the rank's card (``all_to_all_route``, chosen from the
    backend and the tensor's device). ``DataAxis.all_to_all_calls`` counts
    the axis's exchanges by route.

``make_mesh`` builds the axis from a group the caller passes (the tests and
``chip_smoke.py`` do), else from a multi-process launcher's environment
(``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
``GROUP_RANK``, ``MASTER_ADDR`` / ``MASTER_PORT``, as ``torchrun`` sets
them): the default group is made once, on ``nccl`` for ``cuda`` and
``gloo`` for ``cpu``, and the ``LOCAL_WORLD_SIZE`` ranks of each node form
the data axis, the rank on ``cuda:LOCAL_RANK``. Without either it is the
one-rank axis, on which the callers take their single-device paths, as
the JAX package does with one device; ``close_mesh`` ends that group.
``spawn_local_ranks`` starts a module once per card of the host under that
environment, as a launcher would.
"""

from __future__ import annotations

import collections
import dataclasses
import datetime
import os
import socket
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from gnn_pretraining_tpu_torch.utils.device import resolve_device

# How long a rank waits in a collective for the others. Under a fine-tune
# sweep a cell with no data-parallel path (node or link tasks) runs on the
# axis's rank 0 while the other ranks wait at the next cell's first
# collective, for as long as that cell takes.
GROUP_TIMEOUT = datetime.timedelta(hours=12)

_LAUNCHER_AXIS: Dict[str, "DataAxis"] = {}   # device type -> the axis made from the env


class _AllReduce(torch.autograd.Function):
    """Sum over the group; the backward sums the gradient over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = torch.clone(x, memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        out = torch.clone(grad, memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=ctx.group)
        return out, None


def _exchange(x: torch.Tensor, axis: "DataAxis") -> torch.Tensor:
    """Block q of ``x``'s dim 0 to rank q; the blocks received, rank-major."""
    route = axis.all_to_all_route(x.device)
    axis.all_to_all_calls[route] += 1
    x = x.contiguous()
    if route == "host":
        send = x.cpu()
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=axis.group)
        return recv.to(x.device)
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=axis.group)
    return out


class _AllToAll(torch.autograd.Function):
    """The tiled all-to-all over dim 0; its backward is the same exchange."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _exchange(x, axis)

    @staticmethod
    def backward(ctx, grad):
        return _exchange(grad, ctx.axis), None


@dataclasses.dataclass(frozen=True)
class DataAxis:
    """This process's place on the data axis: its ``rank`` among ``size``
    ranks of ``group`` (None: the default group), on ``device``."""
    rank: int = 0
    size: int = 1
    group: Optional[Any] = None
    device: Optional[torch.device] = None
    # The exchanges ``all_to_all`` made, forward and backward, by route.
    all_to_all_calls: collections.Counter = dataclasses.field(
        default_factory=collections.Counter, compare=False, repr=False)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        return _AllReduce.apply(x, self.group) if self.size > 1 else x

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The ranks' ``x`` stacked rank-major along dim 0 (every rank has
        the same shape), differentiable."""
        if self.size == 1:
            return x
        rows, rest = x.shape[0], tuple(x.shape[1:])
        return self.psum(torch.cat([x.new_zeros((self.rank * rows, *rest)), x,
                                    x.new_zeros(((self.size - 1 - self.rank) * rows, *rest))]))

    def all_to_all_route(self, device) -> str:
        """How ``all_to_all`` exchanges tensors on ``device``: ``native``
        (``all_to_all_single`` on the tensors), or ``host`` (gloo with CUDA
        tensors: through host memory)."""
        gloo = dist.get_backend(self.group) == "gloo"
        return "host" if gloo and torch.device(device).type == "cuda" else "native"

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """Dim 0 of ``x`` split into ``size`` blocks, block q sent to rank q,
        the blocks received concatenated in rank order; differentiable."""
        if self.size == 1:
            return x
        if x.shape[0] % self.size:
            raise ValueError(f"all_to_all splits dim 0 ({x.shape[0]}) into {self.size} "
                             "equal blocks")
        return _AllToAll.apply(x, self)

    def pmean(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Each tensor's mean over the ranks (no autograd)."""
        if self.size == 1:
            return list(tensors)
        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.all_reduce(flat, group=self.group)
        flat /= self.size
        return [v.view_as(t) for v, t in zip(flat.split([t.numel() for t in tensors]),
                                             tensors)]

    def barrier(self) -> None:
        """Return once every rank has come here."""
        if self.size > 1:
            self.psum(torch.zeros(1, device=self.device))

    def all_objects(self, obj) -> list:
        """Every rank's ``obj`` (picklable), in rank order."""
        if self.size == 1:
            return [obj]
        out = [None] * self.size
        dist.all_gather_object(out, obj, group=self.group)
        return out

    def from_rank0(self, obj):
        """Rank 0's ``obj`` on every rank."""
        return self.all_objects(obj)[0]


def launcher_env() -> Optional[Dict[str, int]]:
    """What a multi-process launcher says of this process, or None without
    one: world size, rank, local rank, local world size, node and nodes."""
    if "WORLD_SIZE" not in os.environ:
        return None
    world = int(os.environ["WORLD_SIZE"])
    rank = int(os.environ.get("RANK", "0"))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", str(world)))
    return {"world": world, "rank": rank,
            "local_rank": int(os.environ.get("LOCAL_RANK", "0")),
            "local_world": local_world,
            "node": int(os.environ.get("GROUP_RANK", str(rank // local_world))),
            "nodes": max(world // local_world, 1)}


def make_mesh(device=None, group=None) -> DataAxis:
    """The data axis: of ``group``, else of the launcher's node (made once
    per process), else one rank. ``device`` as ``resolve_device`` reads it;
    under a launcher a card becomes ``cuda:LOCAL_RANK``."""
    if group is not None:
        return DataAxis(dist.get_rank(group), dist.get_world_size(group), group,
                        resolve_device(device))
    env = launcher_env()
    device = resolve_device(device)
    if env is None or env["local_world"] == 1:
        return DataAxis(device=device)
    if device.type == "cuda":
        device = torch.device("cuda", env["local_rank"])
        torch.cuda.set_device(device)
    if device.type in _LAUNCHER_AXIS:
        return _LAUNCHER_AXIS[device.type]
    if not dist.is_initialized():
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                init_method="env://", world_size=env["world"],
                                rank=env["rank"], timeout=GROUP_TIMEOUT)
    group = dist.group.WORLD
    if env["nodes"] > 1:            # every rank makes every node's group, in order
        local = env["local_world"]
        for node in range(env["nodes"]):
            g = dist.new_group(list(range(node * local, (node + 1) * local)),
                               timeout=GROUP_TIMEOUT)
            if node == env["node"]:
                group = g
    axis = DataAxis(dist.get_rank(group), dist.get_world_size(group), group, device)
    _LAUNCHER_AXIS[device.type] = axis
    return axis


def close_mesh() -> None:
    """Destroy the process group that ``make_mesh`` made from a launcher's
    environment, if it made one."""
    if _LAUNCHER_AXIS:
        _LAUNCHER_AXIS.clear()
        dist.destroy_process_group()


def free_port() -> int:
    """A TCP port on this host that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn_local_ranks(module: str, argv: Sequence[str], n: int) -> int:
    """Run ``python -m module *argv`` as ``n`` ranks of one node, under the
    environment a launcher gives them (the rendezvous on a free port of
    this host); returns 0 when every rank exits 0, else the first nonzero
    code. A rank that fails ends the others."""
    env = dict(os.environ, WORLD_SIZE=str(n), LOCAL_WORLD_SIZE=str(n), GROUP_RANK="0",
               MASTER_ADDR="localhost", MASTER_PORT=str(free_port()))
    procs = [subprocess.Popen([sys.executable, "-m", module, *argv],
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)))
             for r in range(n)]
    first_failure = 0
    try:
        while any(p.poll() is None for p in procs):
            failed = [p.returncode for p in procs if p.returncode]
            if failed:
                first_failure = first_failure or failed[0]
                for p in procs:
                    if p.poll() is None:
                        p.terminate()
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    return first_failure or next((p.returncode for p in procs if p.returncode), 0)
