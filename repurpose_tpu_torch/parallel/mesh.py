"""The process mesh (``repurpose_tpu/parallel/mesh.py``).

One process ("rank") per card, the ranks laid out over the axes of
``MeshConfig``, row-major as the JAX mesh lays its devices:

- ``data``: each rank trains on its own rows of the global batch and the
  gradients are summed over the axis (the reference's DDP);
- ``model``: Megatron tensor parallelism, each rank holding ``1 / model`` of
  the heads and of the FFN hidden (``sharding.py``); neighbouring ranks;
- ``seq``: sequence parallelism, each rank holding ``T / seq`` positions of
  every activation, attention by ring (``ops/ring_attention.py``);
- ``pipe``: pipeline parallelism, stage s running layers
  ``[s L / S, (s + 1) L / S)`` (``pipeline.py``, ``pipeline_1f1b.py``).

``create_mesh`` returns a ``Mesh``: the axis sizes, this rank's
coordinates, its device and one process group per axis of size > 1. The
collectives the port runs over them are ``all_reduce`` and ``broadcast``,
the two that the gloo backend also runs on CUDA tensors, and the
point-to-point hop ``Mesh.hop`` (``jax.lax.ppermute``'s counterpart: a
shift along the axis without wrapping, or around the ring with ``wrap``,
as ``rotate`` does). A hop posts every send and every receive of the call
at once (``isend`` / ``irecv``, under NCCL one ``batch_isend_irecv``) and
then waits for all of them, so a schedule whose ranks make the same
sequence of hops never deadlocks; a rank with nothing to send or receive
in a hop issues nothing (NCCL's batch refuses an empty list). Gloo sends and receives host tensors
only: under gloo a hop of CUDA tensors is staged explicitly through host
memory (one packed byte buffer each way per hop: one device-to-host copy,
one message, one host-to-device copy).

Devices: rank r takes ``cuda:{LOCAL_RANK}``. Several ranks on one card
(``share_card=True``) need the gloo backend, since NCCL refuses two ranks
on one device; without it a host with more ranks than visible cards
raises. The backend defaults to NCCL on CUDA and gloo on the CPU and is
never switched behind the caller's back.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

from repurpose_tpu_torch import resolve_device
from repurpose_tpu_torch.config import MeshConfig

logger = logging.getLogger(__name__)

AXES = ("data", "model", "seq", "pipe")


def default_backend(device: str | torch.device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def _launcher_ranks() -> tuple[int, int, int, int] | None:
    """(rank, world, local rank, ranks on this host) from torchrun's
    variables, else SLURM's; None for a single process."""
    env = os.environ
    if "RANK" in env and "WORLD_SIZE" in env:
        rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
        local = int(env.get("LOCAL_RANK", rank))
        local_world = int(env.get("LOCAL_WORLD_SIZE", world))
    elif "SLURM_PROCID" in env and "SLURM_NTASKS" in env:
        rank, world = int(env["SLURM_PROCID"]), int(env["SLURM_NTASKS"])
        local = int(env.get("SLURM_LOCALID", 0))
        local_world = int(env.get("SLURM_NTASKS_PER_NODE", str(world)).split("(")[0])
    else:
        return None
    return (rank, world, local, local_world) if world > 1 else None


def rank_device(device: str | torch.device, local_rank: int, local_world: int,
                backend: str, share_card: bool) -> torch.device:
    """This rank's device: the CPU, or ``cuda:{local_rank}``; with
    ``share_card`` the ranks of a host take its cards in turn."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev
    cards = torch.cuda.device_count()
    if share_card:
        if backend != "gloo":
            raise ValueError(f"share_card needs the gloo backend, not {backend!r}: NCCL "
                             "refuses two ranks on one device")
        return torch.device("cuda", local_rank % cards)
    if local_world > cards:
        raise ValueError(f"{local_world} ranks on this host but {cards} visible card(s): "
                         "one rank per card, or share_card=True with the gloo backend")
    return torch.device("cuda", local_rank)


def maybe_initialize_distributed(backend: str | None = None, device: str | torch.device = "cuda",
                                 share_card: bool = False) -> bool:
    """Starts the default process group of a multi-process launch: torchrun's
    ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` / ``MASTER_ADDR`` /
    ``MASTER_PORT``, or SLURM's ``SLURM_PROCID`` / ``SLURM_NTASKS`` /
    ``SLURM_LOCALID`` with ``MASTER_ADDR`` / ``MASTER_PORT`` from the launch
    script. A no-op for a single process or a group already started;
    decides from the environment variables only. On CUDA it first makes this
    rank's card the current device, so call it before anything touches
    CUDA. Returns whether more than one process is in the group."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    ranks = _launcher_ranks()
    if ranks is None:
        return False
    rank, world, local, local_world = ranks
    if "MASTER_ADDR" not in os.environ or "MASTER_PORT" not in os.environ:
        raise ValueError(f"rank {rank} of {world}: set MASTER_ADDR and MASTER_PORT")
    backend = backend or default_backend(device)
    dev = rank_device(device, local, local_world, backend, share_card)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world)
    logger.info("process group: rank %d of %d, %s on %s", rank, world, backend, dev)
    return True


@dataclass(frozen=True)
class Mesh:
    """This rank's place on the (data, model, seq, pipe) mesh."""

    sizes: dict[str, int]
    coords: dict[str, int]
    rank: int
    world: int
    device: torch.device
    backend: str | None  # None: one process, no group
    groups: dict = field(default_factory=dict)  # axis -> ProcessGroup (size > 1)
    group_ranks: dict = field(default_factory=dict)  # axis -> global ranks of the group

    def size(self, axis: str) -> int:
        return self.sizes[axis]

    def coord(self, axis: str) -> int:
        return self.coords[axis]

    def group(self, axis: str):
        return self.groups.get(axis)

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def all_reduce(self, x: torch.Tensor, axis: str, op=dist.ReduceOp.SUM) -> torch.Tensor:
        """``x`` reduced in place over ``axis`` (unchanged where its size is 1)."""
        if self.sizes[axis] > 1:
            dist.all_reduce(x, op=op, group=self.groups[axis])
        return x

    def staged(self) -> bool:
        """Whether a hop goes through host memory: gloo with CUDA tensors."""
        return self.backend == "gloo" and self.device.type == "cuda"

    def broadcast(self, x: torch.Tensor, axis: str, src: int) -> torch.Tensor:
        """``x`` of the rank at coordinate ``src`` of ``axis``, in place on
        every rank of the axis (any dtype: sent as its bytes)."""
        if self.sizes[axis] > 1:
            dist.broadcast(x.view(-1).view(torch.uint8),
                           src=self.group_ranks[axis][src], group=self.groups[axis])
        return x

    def hop(self, axis: str, send=None, recv=None, step: int = 1, wrap: bool = False):
        """One point-to-point hop along ``axis``: the tensors ``send`` go to
        the rank ``step`` coordinates on, and ``recv`` (a list of (shape,
        dtype)) arrive from the rank ``step`` coordinates back; returns the
        received tensors (None where ``recv`` is None). Without ``wrap``
        there is no rank past either end: the caller passes no ``send`` at
        the far end and no ``recv`` at the near one. Every rank of the axis
        must make the same sequence of hops, each with the sends and
        receives that match its neighbours'."""
        n, c = self.sizes[axis], self.coords[axis]
        if n == 1:
            if send is not None or recv is not None:
                raise ValueError(f"a hop along {axis} of size 1")
            return None
        dst, src = c + step, c - step
        if wrap:
            dst, src = dst % n, src % n
        if (send is not None and not 0 <= dst < n) or (recv is not None and not 0 <= src < n):
            raise ValueError(f"hop past the end of {axis}: {c} -> {dst}, {src} -> {c}")
        if send is None and recv is None:  # no part in this hop (a fill or drain tick)
            return None
        staged = self.staged()
        host = torch.device("cpu") if staged else self.device
        ops = []
        if recv is not None:
            nbytes = sum(_nbytes(shape, dtype) for shape, dtype in recv)
            rbuf = torch.empty(nbytes, dtype=torch.uint8, device=host)
            ops.append(("recv", rbuf, self.group_ranks[axis][src]))
        if send is not None:
            sbuf = _pack(send)
            ops.append(("send", sbuf.cpu() if staged else sbuf, self.group_ranks[axis][dst]))
        group = self.groups[axis]
        if self.backend == "nccl":
            works = dist.batch_isend_irecv([
                dist.P2POp(dist.irecv if kind == "recv" else dist.isend, buf, peer, group)
                for kind, buf, peer in ops])
        else:
            works = [(dist.irecv if kind == "recv" else dist.isend)(buf, peer, group=group)
                     for kind, buf, peer in ops]
        for w in works:
            w.wait()
        if recv is None:
            return None
        return _unpack(rbuf.to(self.device) if staged else rbuf, recv)

    def rotate(self, tensors, axis: str, step: int = 1):
        """The ring hop of every rank's ``tensors``: rank c receives rank
        c - step's (``ppermute`` with pairs (i, (i + step) mod n))."""
        return self.hop(axis, send=list(tensors), recv=[(t.shape, t.dtype) for t in tensors],
                        step=step, wrap=True)


def _nbytes(shape, dtype: torch.dtype) -> int:
    n = 1
    for x in shape:
        n *= int(x)
    return n * torch.empty((), dtype=dtype).element_size()


def _pack(tensors) -> torch.Tensor:
    """The tensors' bytes, one after the other, in one uint8 buffer."""
    return torch.cat([t.detach().contiguous().reshape(-1).view(torch.uint8) for t in tensors])


def _unpack(buf: torch.Tensor, spec) -> list[torch.Tensor]:
    out, at = [], 0
    for shape, dtype in spec:
        t = torch.empty(shape, dtype=dtype, device=buf.device)
        n = t.numel() * t.element_size()
        t.reshape(-1).view(torch.uint8).copy_(buf[at : at + n])
        out.append(t)
        at += n
    return out


def _coords(rank: int, sizes: tuple[int, ...]) -> tuple[int, ...]:
    out = []
    for s in reversed(sizes):
        out.append(rank % s)
        rank //= s
    return tuple(reversed(out))


def create_mesh(mesh_cfg: MeshConfig | None = None, backend: str | None = None,
                device: str | torch.device = "cuda", share_card: bool = False) -> Mesh:
    """The mesh of ``mesh_cfg`` over every process of the launch (starting the
    process group from the launcher's variables if no group is up; a single
    process gets a mesh of one). Every rank must call it, in the same order:
    it makes the axes' process groups. ``backend`` must match a group that
    is already up."""
    mesh_cfg = mesh_cfg or MeshConfig()
    maybe_initialize_distributed(backend, device, share_card)
    if dist.is_initialized() and dist.get_world_size() > 1:
        rank, world = dist.get_rank(), dist.get_world_size()
        running = dist.get_backend()
        if backend is not None and running != backend:
            raise ValueError(f"the process group runs {running!r}, not the {backend!r} "
                             "asked for")
        backend = running
        local = int(os.environ.get("LOCAL_RANK", rank))
        dev = rank_device(device, local, int(os.environ.get("LOCAL_WORLD_SIZE", world)),
                          backend, share_card)
    else:
        rank, world, backend, dev = 0, 1, None, resolve_device(device)
    sizes = mesh_cfg.axis_sizes(world)
    coords = _coords(rank, sizes)
    groups, group_ranks = {}, {}
    for a, axis in enumerate(AXES):
        if sizes[a] == 1:
            continue
        # every rank makes every group of the axis, in the same order
        for other in range(world):
            c = _coords(other, sizes)
            if c[a] != 0:
                continue
            members = [r for r in range(world)
                       if all(x == y for i, (x, y) in enumerate(zip(_coords(r, sizes), c))
                              if i != a)]
            g = dist.new_group(members)
            if rank in members:
                groups[axis], group_ranks[axis] = g, members
    if backend == "nccl":
        # NCCL starts a group's communicator at its first collective, and a
        # batch of point-to-point ops may only be that first call if every
        # rank of the group takes part: start them here, before a hop in
        # which some ranks sit out
        for g in groups.values():
            dist.all_reduce(torch.zeros(1, device=dev), group=g)
    return Mesh(sizes=dict(zip(AXES, sizes)), coords=dict(zip(AXES, coords)), rank=rank,
                world=world, device=dev, backend=backend, groups=groups,
                group_ranks=group_ranks)


def mesh_self_check(mesh: Mesh) -> int:
    """An all_reduce of ones over the world, and over each axis group, must
    equal the group's size (reference: utils/distributed.py:181-193).
    Returns the world size; raises on a mismatch."""
    if mesh.world == 1:
        return 1
    ones = torch.ones(1, device=mesh.device)
    dist.all_reduce(ones)
    if int(ones.item()) != mesh.world:
        raise RuntimeError(f"mesh self-check: all_reduce gave {int(ones.item())}, "
                           f"not the world size {mesh.world}")
    for axis, group in mesh.groups.items():
        ones = torch.ones(1, device=mesh.device)
        dist.all_reduce(ones, group=group)
        if int(ones.item()) != mesh.sizes[axis]:
            raise RuntimeError(f"mesh self-check: all_reduce over {axis} gave "
                               f"{int(ones.item())}, not its size {mesh.sizes[axis]}")
    logger.info("mesh self-check passed: %d ranks", mesh.world)
    return mesh.world


def describe_mesh(mesh: Mesh) -> str:
    """Setup dump (reference print_setup_info, utils/distributed.py:505-539)."""
    dev = mesh.device
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    return "\n".join([
        "=== repurpose-tpu torch mesh ===",
        f"rank {mesh.rank}/{mesh.world}",
        f"backend: {mesh.backend or 'none (one process)'}",
        f"device: {dev} ({kind})",
        f"axes: {mesh.sizes}",
        f"coords: {mesh.coords}",
        "hops (seq, pipe): " + ("none" if mesh.world == 1 else
                                "gloo isend/irecv staged through host memory"
                                if mesh.staged() else f"{mesh.backend} isend/irecv"),
    ])
