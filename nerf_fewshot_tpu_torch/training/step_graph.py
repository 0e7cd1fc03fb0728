"""The kernel-path training step as a CUDA graph: the port's counterpart of
the JAX trainer's one-dispatch epoch (``epoch_fn``,
``nerf_fewshot_tpu/training/trainer.py:474-537``, two nested ``lax.scan``s
compiled into one executable per phase).

``Trainer.epoch_steps`` on a card splits an epoch of the kernel path into
host work done once per epoch (the permutations, the masks, the lr and the
Adam table, copied into the buffers of ``StaticStep``, allocated once per
phase) and a per-step body that reads only device buffers and a device step
index (the Adam kernel's counter): the batch gather, the jitter draws,
``fused_train_loss_grad`` (with DINO conditioning, the feature sampler's
kernel first, the step's view read from the device; with a LoRA trunk the
packing kernel before kernel 1 and the VJP kernel after it, into the
trainer's packed-weight and gradient buffers), the gradient buffers, the
clip and the Adam kernel. Under an NCCL mesh (the JAX trainer's
``jax.jit(epoch_fn, in_shardings=...)`` with the ``psum`` inside its
``shard_map``) each rank's body gathers its rows of the batch and holds the
all-reduce of the gradient buffer and the loss
(``parallel/mesh.py:all_reduce_sum_``) between kernel 1 and the clip.
``StepGraph`` captures that body once per phase shape, after warm-up steps
on a side stream (under a mesh they also make NCCL's communicator, which a
capture cannot), and replays it once per minibatch: the host pays one graph
launch a step, the device runs the same kernels in the same order, bit for
bit. The trainer's generator is registered with the graph, so every replay
draws the jitter the eager step would have.

A kernel wrapper counts its launches when it is called, and so does
``all_reduce_sum_`` (``allreduce``); a replay calls no wrapper.
``StepGraph`` therefore takes back the counts the capture added (nothing ran
then) and adds, at every replay, the launches the capture recorded: the
counts stay the kernels' and collectives' real executions.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional

import torch

from nerf_fewshot_tpu_torch.parallel.mesh import all_reduce_sum_
from nerf_fewshot_tpu_torch.render import kernels as tk
from nerf_fewshot_tpu_torch.render import train_kernel as tt
from nerf_fewshot_tpu_torch.render.lora_pack import lora_pack, lora_pack_vjp
from nerf_fewshot_tpu_torch.render.point_features import sample_point_features
from nerf_fewshot_tpu_torch.render.pipeline import RenderSettings
from nerf_fewshot_tpu_torch.training.optim import AdamKernel

# eager steps on a side stream before a capture (torch's graph docs: the
# lazy initializations of the body's ops happen outside the capture)
WARMUP_STEPS = 2


# the wrappers that count their kernels' launches (the functions themselves,
# bound here: a caller may put another function in a module's place)
_WRAPPERS = {"fwd_pe": tk.fused_render_fwd_pe, "fwd": tk.fused_render_fwd,
             "render_bwd": tk.fused_render_bwd, "point_features": sample_point_features,
             "lora_pack": lora_pack, "lora_pack_vjp": lora_pack_vjp,
             "allreduce": all_reduce_sum_}
_TRAIN = tt.fused_train_objective


def kernel_launch_counts() -> Dict[str, int]:
    """Every hand-written kernel's launch count, by kernel, and the mesh
    step's all-reduces (``allreduce``)."""
    return {**{k: f.launches for k, f in _WRAPPERS.items()}, **_TRAIN.launches,
            "adam": AdamKernel.launches}


def _add_launch_counts(delta: Dict[str, int]) -> None:
    for k, f in _WRAPPERS.items():
        f.launches += delta[k]
    for k in _TRAIN.launches:
        _TRAIN.launches[k] += delta[k]
    AdamKernel.launches += delta["adam"]


class StepGraph:
    """``body()`` captured once on ``stream`` (a side stream, after its
    warm-up there) with ``generator`` registered, and replayed by
    ``replay()`` on the current stream. A failed capture raises. Keeps the
    kernels' scratch buffers the capture saw alive for its lifetime, and
    what the capture cost: ``capture_ms`` (the body's host time under
    capture), ``instantiate_ms`` (``capture_end``), ``pool_mb`` (device
    memory the graph's private pool reserved) and ``launches`` (the kernel
    launches one replay makes, by kernel, and its all-reduces)."""

    def __init__(self, body: Callable[[], None], stream: torch.cuda.Stream,
                 generator: torch.Generator):
        device = stream.device
        self.graph = torch.cuda.CUDAGraph()
        self.graph.register_generator_state(generator)
        before = kernel_launch_counts()
        reserved = torch.cuda.memory_reserved(device)
        t0 = time.perf_counter()
        with torch.cuda.stream(stream):
            self.graph.capture_begin()
            try:
                body()
            except BaseException:
                try:  # end the broken capture; the body's error is the one to see
                    self.graph.capture_end()
                except RuntimeError:
                    pass
                raise
            t1 = time.perf_counter()
            self.graph.capture_end()
        t2 = time.perf_counter()
        after = kernel_launch_counts()
        self.launches = {k: after[k] - before[k] for k in after}
        _add_launch_counts({k: -v for k, v in self.launches.items()})
        self.capture_ms = (t1 - t0) * 1e3
        self.instantiate_ms = (t2 - t1) * 1e3
        self.pool_mb = (torch.cuda.memory_reserved(device) - reserved) / 2 ** 20
        self._keep = tk.scratch_buffers()

    def replay(self) -> None:
        self.graph.replay()
        _add_launch_counts(self.launches)


@dataclasses.dataclass
class StaticStep:
    """One phase's buffers of the static-buffer step, allocated once per
    phase: ``rays`` (V * n_rays, 9) the views' ``[o | d | rgb]`` rows one
    view after the other; per step ``rows`` (n_steps, B) the batch's rows of
    ``rays``, ``mask`` (n_steps, B) its validity, ``views`` (n_steps,) its
    view, ``losses`` (n_steps,) its loss, filled by the step; ``adam`` the
    Adam kernel over the trainer's optimizer (its counter is the device step
    index); ``graph`` the captured body, once captured. Under a mesh
    ``batch`` is padded to a multiple of the world size and ``shard`` is
    this rank's rows of it (else all of them)."""

    phase_idx: int
    batch: int
    n_batches: int
    n_samples: int
    settings: RenderSettings
    shard: slice
    rays: torch.Tensor
    rows: torch.Tensor
    mask: torch.Tensor
    views: torch.Tensor
    losses: torch.Tensor
    adam: Optional[AdamKernel] = None
    graph: Optional[StepGraph] = None

    @property
    def n_steps(self) -> int:
        return self.rows.shape[0]
