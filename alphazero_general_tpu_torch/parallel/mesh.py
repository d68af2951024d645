"""Data parallelism over processes — the port of
alphazero_general_tpu/parallel/mesh.py (reference: Coach.py:290-361, the
actor fan-out and the single learner; SURVEY.md §2.5).

The JAX package runs one program over a device mesh whose ``batch`` axis
shards games and train batches. The port runs one process per device,
PyTorch's idiom (``torchrun --nproc_per_node=W``), and keeps the mesh's
semantics by hand:

* parameters are the same on every rank: ``replicate_module`` broadcasts
  rank 0's after construction and after every load (``replicate_tree``);
* the gradient is the mean over the global batch: ``all_reduce_mean_``
  (the psum that ``make_sharded_train_step`` has XLA insert);
* BatchNorm's training statistics are the global batch's
  (``global_moments``, used by ``models.architectures.Norm``);
* every rank takes the same host-side decisions: the Coach's numpy stream
  is seeded alike on every rank and drawn only for batch-global choices;
* a game batch of B is cut into ranks by ``rank_slice``: rank r plays
  games ``[r·B/W, (r+1)·B/W)``, and ``GameShard`` makes each random draw
  over a batch of games the global batch's draw, cut to the rank's games,
  so that W ranks play the games one rank would ("RNG keys are identical
  on all hosts", JAX mesh.py:53-66).

``host_local_to_global``, ``local_rows``, ``shard_leading_axis`` and the
shardings have no counterpart: a rank only ever holds its own rows.

Only ``all_reduce`` and ``broadcast`` are used, the two collectives that
Gloo runs on CUDA tensors as well as on CPU ones; an all-gather is an
``all_reduce`` over a zero-padded buffer. Backends: NCCL for CUDA devices,
Gloo for the CPU (and for ranks that share one card, whose group the
caller creates itself).

Every collective here is a no-op without a process group, so the
single-process path runs the same code.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist


def is_distributed() -> bool:
    """Whether a process group exists."""
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if is_distributed() else 1


def rank() -> int:
    return dist.get_rank() if is_distributed() else 0


def local_device(device="cuda") -> torch.device:
    """This rank's device: ``cuda:LOCAL_RANK`` for a CUDA device given
    without an index (torchrun's ``LOCAL_RANK``, 0 without it), else
    ``device`` itself."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return device


def init_distributed(device="cuda") -> bool:
    """Join the process group that torchrun describes (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``):
    NCCL for a CUDA ``device``, Gloo for the CPU. Returns True when a group
    exists afterwards: at once, doing nothing, when one exists already
    (JAX mesh.py:70-71); False without the launcher's variables. Under
    torchrun a group forms at any world size, one rank included."""
    if is_distributed():
        return True
    env = os.environ
    if "WORLD_SIZE" not in env or "MASTER_ADDR" not in env:
        return False
    device = local_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        "nccl" if device.type == "cuda" else "gloo", init_method="env://",
        world_size=int(env["WORLD_SIZE"]), rank=int(env.get("RANK", 0)))
    return True


def mesh_size(requested: int, world: int, batch_sizes) -> int:
    """JAX's ``usable_devices`` arithmetic (mesh.py:34-50) over ``world``
    devices: the largest count <= ``requested`` (-1 or 0: all) that divides
    every positive batch size."""
    n = world if requested in (-1, 0) else int(requested)
    n = max(1, min(n, world))
    sizes = [int(b) for b in batch_sizes if int(b) > 0]
    d = n
    while d > 1 and any(b % d for b in sizes):
        d -= 1
    return d


def usable_devices(requested: int, *batch_sizes: int) -> int:
    """The ranks that share the batches: the world size, where JAX's
    arithmetic (``mesh_size``) keeps every rank. A process cannot leave
    the group, so where the JAX package would shrink its mesh this raises
    ValueError instead."""
    world = world_size()
    d = mesh_size(requested, world, batch_sizes)
    if d != world:
        sizes = [int(b) for b in batch_sizes if int(b) > 0]
        raise ValueError(
            f"{world} ranks cannot share the batch sizes {sizes} evenly "
            f"(mesh_batch_axis={requested} gives {d}); the JAX package "
            "would shrink its mesh, but a rank cannot leave the group: "
            "make every batch size a multiple of the world size")
    return world


def rank_slice(batch: int) -> slice:
    """This rank's games of a global batch of ``batch``."""
    w, r = world_size(), rank()
    if batch % w:
        raise ValueError(f"a batch of {batch} does not split over {w} "
                         "ranks")
    return slice(r * batch // w, (r + 1) * batch // w)


def _backend_tensor(x: torch.Tensor) -> torch.Tensor:
    """``x`` where the group's backend takes it: NCCL needs CUDA tensors,
    Gloo takes CPU and CUDA ones."""
    if dist.get_backend() == "nccl" and x.device.type != "cuda":
        return x.to(torch.device("cuda", torch.cuda.current_device()))
    return x


def _all_reduce(x, op) -> torch.Tensor:
    """A reduced copy of ``x`` (a tensor or a number) on ``x``'s device."""
    t = torch.as_tensor(x)
    if not is_distributed():
        return t.clone()
    buf = _backend_tensor(t.clone())
    dist.all_reduce(buf, op=op)
    return buf.to(t.device)


def all_reduce_sum(x) -> torch.Tensor:
    return _all_reduce(x, dist.ReduceOp.SUM)


def all_reduce_min(x) -> torch.Tensor:
    return _all_reduce(x, dist.ReduceOp.MIN)


def all_reduce_max(x) -> torch.Tensor:
    return _all_reduce(x, dist.ReduceOp.MAX)


def barrier() -> None:
    if is_distributed():
        dist.barrier()


def all_gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every rank's rows of ``x`` [b, ...] in rank order, [W·b, ...]: an
    ``all_reduce`` of a zero-padded buffer holding this rank's rows at its
    place."""
    w = world_size()
    if w == 1:
        return x
    b = x.shape[0]
    buf = torch.zeros((w * b,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    buf[rank() * b:(rank() + 1) * b] = x
    return all_reduce_sum(buf)


def replicate_module(module: torch.nn.Module) -> None:
    """Rank 0's parameters and buffers on every rank, in place
    (``replicate_tree``), each written by a ``copy_`` (which moves the
    version counters that the inference caches read)."""
    if not is_distributed():
        return
    with torch.no_grad():
        for t in module.state_dict().values():
            buf = _backend_tensor(t.clone())
            dist.broadcast(buf, src=0)
            t.copy_(buf)


def all_reduce_mean_(module: torch.nn.Module, *extra: torch.Tensor):
    """The gradients of ``module`` averaged over the ranks, in place, with
    ``extra`` scalars (the step's losses) averaged in the same collective;
    returns the averaged extras. One ``all_reduce`` of one flat buffer."""
    if not is_distributed():
        return extra
    grads = [p.grad for p in module.parameters() if p.grad is not None]
    flat = torch.cat([g.reshape(-1).to(torch.float32) for g in grads]
                     + [e.detach().reshape(1).to(torch.float32)
                        for e in extra])
    flat = _backend_tensor(flat)
    dist.all_reduce(flat)
    flat = flat.to(grads[0].device if grads else flat.device) \
        / world_size()
    i = 0
    for g in grads:
        g.copy_(flat[i:i + g.numel()].view_as(g))
        i += g.numel()
    return tuple(flat[i + k] for k in range(len(extra)))


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks with a gradient: the backward sums the incoming
    gradients over the ranks too (every rank's loss reads the sum)."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g)
        return g


def global_moments(xf: torch.Tensor, dims) -> tuple:
    """Per-channel mean and E[x²] of ``xf`` over ``dims`` and over every
    rank's batch, as XLA's sharded BatchNorm takes them: one ``all_reduce``
    of the channel sums, the sums of squares and the count, with a gradient
    through it (the gradient of each rank's input carries every rank's
    loss through the shared statistics)."""
    count = torch.full((1,), float(xf.numel() // xf.shape[1]),
                       dtype=xf.dtype, device=xf.device)
    local = torch.cat([xf.sum(dim=dims), (xf * xf).sum(dim=dims), count])
    tot = _AllReduceSum.apply(local)
    C = xf.shape[1]
    return tot[:C] / tot[2 * C], tot[C:2 * C] / tot[2 * C]


class GameShard:
    """A ``torch.Generator`` seen from one rank's games: a draw over a
    batch of games is taken over the global batch of ``total`` games (the
    generator is seeded alike on every rank) and cut to this rank's
    ``rank_slice``, so each game gets the draw it would get in a
    one-rank run. Only ``draw_uniform`` and ``draw_gamma`` take one; a
    search passes it through to them."""

    def __init__(self, generator: torch.Generator, total: int):
        self.generator = generator
        self.total = int(total)
        self.rows = rank_slice(self.total)


def draw_uniform(shape, generator, device) -> torch.Tensor:
    """Uniform [0, 1) draws of ``shape`` [B, ...] (B games) from a
    ``torch.Generator`` or a ``GameShard``."""
    if isinstance(generator, GameShard):
        full = torch.rand((generator.total,) + tuple(shape[1:]),
                          generator=generator.generator, device=device)
        return full[generator.rows]
    return torch.rand(shape, generator=generator, device=device)


def draw_gamma(alpha: torch.Tensor, generator) -> torch.Tensor:
    """Standard Gamma draws at ``alpha`` [B, A] (one row a game) from a
    ``torch.Generator`` or a ``GameShard``; the latter gathers every rank's
    rows of ``alpha`` (a Gamma draw's use of the stream depends on its
    alpha) and draws them all."""
    if isinstance(generator, GameShard):
        full = all_gather_rows(alpha.contiguous())
        return torch._standard_gamma(full, generator=generator.generator)[
            generator.rows]
    return torch._standard_gamma(alpha, generator=generator)


def shard_generator(generator: Optional[torch.Generator], total: int):
    """``generator`` as a ``GameShard`` over ``total`` games where a group
    of more than one rank exists, else unchanged."""
    if generator is None or world_size() == 1:
        return generator
    return GameShard(generator, total)
