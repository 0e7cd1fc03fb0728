"""Data-parallel training over ``torch.distributed`` (counterpart of
``nerf_fewshot_tpu/parallel/mesh.py``).

The strategy is the JAX package's: ray-batch data parallelism. The NeRF
MLP is replicated; each rank holds one device and takes a contiguous block
of every minibatch's rows; the loss and the gradients are summed over the
ranks. Where the JAX package lets XLA insert the ``psum``, the port calls
one all-reduce over a flat buffer: ``all_reduce_sum`` concatenates its
tensors, ``all_reduce_sum_`` sums one flat tensor in place (the trainer's
gradient buffer with the loss beside it), which a CUDA graph can capture on
an NCCL mesh (``can_capture``).

One process per rank. The backend follows the rank's device: NCCL on a
card, Gloo on the CPU, or whatever the caller names. Gloo all-reduces CUDA
tensors too, which lets two ranks share one card (NCCL refuses that). A
request for NCCL with no card raises: nothing falls back to the CPU.
``launch`` starts the ranks of a run on this host.
"""

from __future__ import annotations

import dataclasses
import datetime
import gc
import os
import queue
import socket
import sys
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from nerf_fewshot_tpu_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D data-parallel mesh: this process's rank in ``group`` (None: the
    default group), the world size, the rank's device and the group's
    backend."""

    rank: int
    world_size: int
    device: torch.device
    backend: str
    group: Any = None


def default_backend(device: DeviceLike) -> str:
    """NCCL for a CUDA device, Gloo for the CPU."""
    return "nccl" if torch.device("cuda" if device is None else device).type == "cuda" else "gloo"


def rank_device(device: DeviceLike, rank: int) -> torch.device:
    """``device`` for ``rank``: a ``cuda`` device without an index becomes
    ``cuda:$LOCAL_RANK`` (the rank when unset) modulo the cards present;
    a CUDA request with no card raises (``resolve_device``)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", rank))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    return dev


def _check_backend(backend: str, device: torch.device) -> None:
    if backend == "nccl" and (device.type != "cuda" or not torch.cuda.is_available()):
        raise RuntimeError(f"the NCCL backend needs a CUDA device; this rank's device is {device} "
                           f"(use the gloo backend on the CPU)")


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device: DeviceLike = None,
    timeout_s: float = 600.0,
) -> None:
    """Join the process group: call once per process before ``make_mesh``.

    Explicit arguments win; otherwise the ``env://`` variables that
    ``torchrun`` sets are read (``MASTER_ADDR:MASTER_PORT``, ``WORLD_SIZE``,
    ``RANK``) and the group joins through ``env://``, which also connects
    to a ``torchrun`` agent's store. ``backend`` defaults to
    ``default_backend(device)`` (``device`` default ``cuda``); NCCL with no
    card raises."""
    env = os.environ
    init_method = f"tcp://{coordinator_address}"
    if coordinator_address is None and "MASTER_ADDR" in env and "MASTER_PORT" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
        init_method = "env://"
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    missing = [name for name, v in (("coordinator_address (MASTER_ADDR, MASTER_PORT)",
                                     coordinator_address),
                                    ("num_processes (WORLD_SIZE)", num_processes),
                                    ("process_id (RANK)", process_id)) if v is None]
    if missing:
        raise ValueError(f"initialize_multihost: no {', '.join(missing)} given or in the "
                         f"environment")
    backend = backend or default_backend(device)
    _check_backend(backend, rank_device(device, process_id))
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout_s))


def make_mesh(device: DeviceLike = None, group: Any = None) -> Mesh:
    """The mesh over ``group`` (default: every rank of the joined process
    group), this rank on ``rank_device(device)``; ``device`` defaults to
    ``cpu`` under Gloo and ``cuda`` under NCCL, where the card is made
    current."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; call initialize_multihost first")
    backend = str(dist.get_backend(group))
    rank = dist.get_rank(group)
    dev = rank_device(device if device is not None else
                      ("cpu" if backend == "gloo" else "cuda"), rank)
    _check_backend(backend, dev)
    if backend == "nccl":
        torch.cuda.set_device(dev)
    return Mesh(rank=rank, world_size=dist.get_world_size(group), device=dev, backend=backend,
                group=group)


def all_reduce_sum(mesh: Mesh, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Each tensor summed over the ranks, by one all-reduce of their
    flattened concatenation (every rank gets the same values)."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.group)
    return [part.reshape(t.shape) for part, t in
            zip(torch.split(flat, [t.numel() for t in tensors]), tensors)]


def all_reduce_sum_(mesh: Mesh, flat: torch.Tensor) -> torch.Tensor:
    """``flat`` summed over the ranks in place, by one all-reduce (no copy:
    a CUDA graph captured on an NCCL mesh replays it on the same buffer).
    Counts every call in ``all_reduce_sum_.launches``."""
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.group)
    all_reduce_sum_.launches += 1
    return flat


all_reduce_sum_.launches = 0


def can_capture(mesh: Mesh) -> bool:
    """Whether the mesh's collectives can be captured in a CUDA graph: NCCL
    enqueues its kernels on the card's streams, which a capture records once
    its communicator exists (the trainer's warm-up steps, outside the
    capture, make it); Gloo runs its collectives on the host."""
    return mesh.backend == "nccl"


def _rows(n_global: int, rank: int, world_size: int) -> slice:
    if n_global % world_size:
        raise ValueError(f"{n_global} rows do not split evenly over {world_size} ranks "
                         f"(the trainer pads its batches to a multiple of the world size)")
    per = n_global // world_size
    return slice(rank * per, (rank + 1) * per)


def process_local_slice(n_global: int, mesh: Optional[Mesh] = None) -> slice:
    """This rank's contiguous row range of a global ray batch (host-local
    data loading: each rank materializes only its shard). ``n_global`` must
    split evenly over the ranks."""
    if mesh is None:
        return _rows(n_global, dist.get_rank(), dist.get_world_size())
    return _rows(n_global, mesh.rank, mesh.world_size)


def make_global_batch(mesh: Mesh, local_arrays) -> Tuple[torch.Tensor, ...]:
    """This rank's rows of each array, on its device: the port's global
    batch is the set of the ranks' shards, and nothing crosses ranks."""
    return tuple(torch.as_tensor(np.asarray(a), device=mesh.device) for a in local_arrays)


def shard_batch(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's contiguous block of the leading (ray-batch) axis of a
    batch every rank holds whole, on its device."""
    return x[_rows(x.shape[0], mesh.rank, mesh.world_size)].to(mesh.device)


def replicate(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The whole of ``x`` on this rank's device (parameters, keys, scalars)."""
    return x.to(mesh.device)


def data_parallel_train_step(loss_fn: Callable[..., torch.Tensor],
                             optimizer: torch.optim.Optimizer, mesh: Mesh) -> Callable:
    """Wrap ``loss_fn(*args) -> loss``, the mean loss over this rank's rows,
    into a step: backward, the gradients of every parameter of
    ``optimizer`` averaged over the ranks (with the loss, in one
    all-reduce), then ``optimizer.step()``. Returns the averaged loss, which
    with equal shards is the mean over the global batch, as the JAX step's
    replicated output is."""
    params = [p for g in optimizer.param_groups for p in g["params"]]

    def step(*args) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(*args)
        loss.backward()
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
        loss, *grads = all_reduce_sum(mesh, [loss.detach(), *grads])
        for p, g in zip(params, grads):
            p.grad = g / mesh.world_size
        optimizer.step()
        return loss / mesh.world_size

    return step


# ----------------------------------------------------------------- launch


def free_port() -> int:
    """A TCP port on localhost that is free now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def shutdown() -> None:
    """Leave the process group: drop the locals of the frames an exception
    in flight has left (called from a ``finally``), collect garbage, then
    ``dist.destroy_process_group()``. NCCL destroys a communicator only
    once every CUDA graph that captured one of its collectives is destroyed
    (a graphed mesh trainer's step, ``training/step_graph.py``), so a graph
    still alive, in a reference cycle or a live trainer, blocks this call
    for good: drop the mesh's trainers first."""
    error = sys.exc_info()[1]
    if error is not None:
        traceback.clear_frames(error.__traceback__)
    gc.collect()
    dist.destroy_process_group()


def _rank_main(fn, rank, devices, address, backend, args, results) -> None:
    try:
        initialize_multihost(address, len(devices), rank, backend=backend, device=devices[rank])
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    try:
        out = fn(make_mesh(devices[rank]), *args)
    except BaseException:
        # put before the teardown: a failed rank's peers may wait in a collective
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        shutdown()
    results.put((rank, True, out))


def launch(fn: Callable, devices: Sequence[DeviceLike], args: Tuple = (),
           backend: Optional[str] = None, timeout_s: float = 600.0) -> List[Any]:
    """Run ``fn(mesh, *args)`` on ``len(devices)`` ranks of a new process
    group on this host, rank ``i`` in a spawned process on ``devices[i]``
    (``backend`` as ``initialize_multihost`` picks it from ``devices[0]``),
    and return their results by rank. ``fn`` is a module-level function; it
    and its arguments and result are pickled. Raises with the failing ranks'
    tracebacks when one fails (the others are then stopped), and when the
    run outlasts ``timeout_s``."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    address = f"localhost:{free_port()}"
    backend = backend or default_backend(devices[0])
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, rank, list(devices), address, backend, args, results))
             for rank in range(len(devices))]
    for p in procs:
        p.start()
    out, failed = {}, {}
    deadline = time.monotonic() + timeout_s
    try:
        while len(out) + len(failed) < len(procs) and not failed:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue.Empty:
                silent = [i for i, p in enumerate(procs)
                          if p.exitcode not in (None, 0) and i not in failed]
                if silent:
                    failed.update({i: f"exited with code {procs[i].exitcode}" for i in silent})
                elif time.monotonic() > deadline:
                    raise TimeoutError(f"launch: {len(procs)} ranks still running after "
                                       f"{timeout_s} s")
                continue
            (out if ok else failed)[rank] = value
        if failed:
            raise RuntimeError("launch: " + "\n".join(
                f"rank {r} failed:\n{tb}" for r, tb in sorted(failed.items())))
        for p in procs:
            p.join(timeout=60)
        return [out[r] for r in range(len(procs))]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
