"""The data-parallel step that an NCCL mesh replays as a CUDA graph
(``Trainer._static_body`` under a mesh: the rank's rows, the whole batch's
draws, kernel 1 on the shard, the gradients and the loss summed over the
ranks by one in-place all-reduce, the clip and the Adam step), on the CPU.

Gloo's collectives cannot be captured, so a Gloo mesh steps eagerly
(``step_mode_reason`` says so); but the body runs as it is on Gloo ranks
(``Trainer._static_epoch_steps``), which holds it to the eager mesh step
bit for bit: per-step losses, parameters and Adam state, for the baseline
across a phase change, DINO with trunk LoRA across the two-phase freeze,
hierarchical sampling and ``invalid_fill: mean``, with a first-phase batch
that does not split evenly (padded to the world size). The body is also
held to the JAX mesh trainer. On the card ``tests/test_torch_port_cuda.py``
(marked ``cuda``) and ``chip_smoke.py`` hold the graph replays on a
one-rank NCCL mesh to the eager mesh step and to no mesh.

One ``parallel.mesh.launch`` of two Gloo ranks (one CPU thread each) runs
every rank job; the JAX package is imported inside the tests only.
Shapes: 16x16 views, a 3 x 128 trunk; phase 0 8x8 rays in batches of 47
(padded to 48; a ragged masked tail of 32), phase 1 16x16 in batches of 96.
"""

import gc
import weakref

import numpy as np
import pytest
import torch
import torch.distributed as dist

from nerf_fewshot_tpu_torch.data.synthetic import lego_like_scene, make_scene_dataset
from nerf_fewshot_tpu_torch.parallel import mesh as pmesh
from nerf_fewshot_tpu_torch.training import config as tcfg
from nerf_fewshot_tpu_torch.training.trainer import Trainer

RES = 16
TIMEOUT = 240  # seconds for the spawned ranks
DINO = {"model": {"use_dino": True, "dino_model_type": "single_scale"}}
CASES = {
    "baseline": {},
    # DINO features sampled on the rank's shard, the LoRA freeze at epoch 1
    "dino_lora": {**DINO, "nerf_model": {"lora_rank": 4},
                  "optimizer": {"lora_only_after_epoch": 1}},
    "hierarchical": {"rendering": {"chunk_size": 128, "n_importance": 8}},
    "mean": {**DINO, "dino_model": {"invalid_fill": "mean"}},
}
# one phase of 64 rays per view in batches of 48 (ragged tail of 32)
JAX_MESH = {"training": {"epochs": 2, "phases": [
    {"start": 0, "H": 8, "n_samples": 8, "batch_size": 48}]}}


def _config(**over):
    d = {
        "experiment": {"name": "port-mesh-graph"},
        "data": {"resolution": RES, "num_views": 2},
        "nerf_model": {"pos_freq": 10, "dir_freq": 4, "hidden_dim": 128, "num_layers": 3,
                       "sigma_bias": 0.1},
        "training": {"epochs": 2, "phases": [
            {"start": 0, "end": 1, "H": 8, "n_samples": 8, "batch_size": 47},
            {"start": 1, "H": RES, "n_samples": 12, "batch_size": 96}]},
        "optimizer": {"lr": 5e-4, "weight_decay": 1e-6, "lr_milestones": [1]},
        "rendering": {"chunk_size": 128},
        "output": {"save_dir": "unused", "val_freq": 1000, "save_freq": 1000},
        "seed": 0,
    }
    for k, v in over.items():
        d[k] = {**d.get(k, {}), **v}
    return d


def _feats(case):
    if "model" not in CASES[case]:
        return None
    return np.random.default_rng(4).standard_normal((2, 4, 4, 64)).astype(np.float32)


def _trainer(mesh, cfg_dict, feats=None, jitter=True):
    data = make_scene_dataset(lego_like_scene(), 2, img_size=RES, gt_samples=32, device="cpu")
    tr = Trainer(tcfg.config_from_dict(cfg_dict), data, device="cpu", mesh=mesh,
                 dino_features=feats)
    if not jitter:
        orig = tr._render_settings
        tr._render_settings = lambda n, training: orig(n, False)
    return tr


def _state(tr):
    """The parameters and the Adam state (both moments, the step) by name."""
    names = {id(p): n for n, p in tr.model.named_parameters()}
    adam = {names[id(p)]: {k: tr.optimizer.state[p][k].numpy().copy()
                           for k in ("exp_avg", "exp_avg_sq", "step")}
            for p in tr.optimizer.param_groups[0]["params"]}
    return {"params": {k: v.numpy().copy() for k, v in tr.model.state_dict().items()},
            "adam": adam}


def _run(tr, static, epochs=(0, 1)):
    """Each epoch's per-step losses and all-reduces, through the static body
    run as it is or through the eager steps; the state after them."""
    steps, reduces, batches = [], [], []
    for e in epochs:
        before = pmesh.all_reduce_sum_.launches
        steps.append((tr._static_epoch_steps(e) if static else tr.epoch_steps(e)).numpy())
        reduces.append(pmesh.all_reduce_sum_.launches - before)
        batches.append(tr._static.batch if static else None)
    return {"steps": steps, "reduces": reduces, "batches": batches,
            "mode": (tr.step_mode, tr.step_mode_reason), "path": tr.kernel_path, **_state(tr)}


# ------------------------------------------------------------- rank jobs


def _rank_job(mesh, jax_init):
    torch.set_num_threads(1)
    out = {}
    for case, over in CASES.items():
        out[case] = {kind: _run(_trainer(mesh, _config(**over), _feats(case)), kind == "static")
                     for kind in ("static", "eager")}
        # a trainer whose step body ran is freed by reference counting when
        # dropped: no cycle keeps its graphs (on a card), and with them the
        # NCCL communicator, alive (``mesh.shutdown``)
        tr = _trainer(mesh, _config(**over), _feats(case))
        tr._static_epoch_steps(0)
        gc.disable()
        try:
            alive = weakref.ref(tr)
            del tr
            out[case]["freed"] = alive() is None
        finally:
            gc.enable()
    jax_cfg = _config(rendering={"chunk_size": 128}, optimizer={"lr_milestones": []},
                      **JAX_MESH)
    tr = _trainer(mesh, jax_cfg, jitter=False)
    tr.model.load_state_dict(jax_init)
    out["jax_mesh"] = _run(tr, True)
    plain = _trainer(mesh, _config(rendering={"chunk_size": 128, "backend": "xla"}))
    plain.epoch_steps(0)
    try:
        plain._static_epoch_steps(1)
        refused = None
    except ValueError as e:
        refused = str(e)
    out["plain"] = {"mode": (plain.step_mode, plain.step_mode_reason), "refused": refused}
    # the valid-ray count: the whole batch's local sum against the shards'
    # all-reduced sums, over ragged masks of the trainer's batch widths
    rng = np.random.default_rng(7)
    counts = []
    for n in (48, 96, 4096, 8192):
        for valid in (0, 1, n // 3, n - 1, n):
            mask = torch.zeros(n)
            mask[rng.permutation(n)[:valid]] = 1.0
            shard = torch.sum(mask[pmesh.process_local_slice(n, mesh)]).reshape(1)
            (reduced,) = pmesh.all_reduce_sum(mesh, [shard])
            counts.append((torch.sum(mask).numpy().copy(), reduced[0].numpy().copy()))
    out["counts"] = counts
    return out


@pytest.fixture(scope="module")
def ranks():
    """The JAX trainer's init at seed 0 (numpy leaves), transplanted, and
    the two Gloo ranks' job results."""
    import jax
    import jax.numpy as jnp

    from nerf_fewshot_tpu.models import NeRFMLP as JNeRFMLP
    from nerf_fewshot_tpu_torch.models.mlp import nerf_mlp_from_jax

    model = JNeRFMLP(pos_freq=10, dir_freq=4, use_viewdirs=True, hidden_dim=128, num_layers=3,
                     sigma_bias_init=0.1)
    key = jax.random.split(jax.random.key(0))[0]  # the JAX trainer's (trainer.py:160-175)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(model.init)(
        key, jnp.zeros((1, 3)), jnp.zeros((1, 3)))["params"])
    results = pmesh.launch(_rank_job, ["cpu", "cpu"], (nerf_mlp_from_jax(params),),
                           timeout_s=TIMEOUT)
    return params, results


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.int32 if a.dtype == np.float32 else np.int64)


def _same(a, b, label):
    assert a.shape == b.shape and np.array_equal(_bits(a), _bits(b)), label


def _same_state(a, b, label):
    for k in a["params"]:
        _same(a["params"][k], b["params"][k], f"{label} {k}")
    assert sorted(a["adam"]) == sorted(b["adam"]) and a["adam"], label
    for k in a["adam"]:
        for key in ("exp_avg", "exp_avg_sq", "step"):
            _same(a["adam"][k][key], b["adam"][k][key], f"{label} {k} {key}")


# ------------------------------------------------------------------ tests


@pytest.mark.parametrize("case", list(CASES))
def test_static_mesh_body_is_bit_equal_to_the_eager_mesh_step(ranks, case):
    """Epochs 0 and 1 on each of two Gloo ranks (jitter on; the lr milestone,
    the phase change and, for ``dino_lora``, the freeze at 1): the static
    body (each rank's rows of its gathered batch, the whole batch's draws,
    the in-place all-reduce of the gradient buffer and the loss) against
    the eager mesh step: per-step losses, parameters and Adam state bit for
    bit on each rank, the ranks bit-equal; one all-reduce a step in both
    (the valid-ray count is the whole mask's local sum, no collective)."""
    _, results = ranks
    for rank, r in enumerate(results):
        static, eager = r[case]["static"], r[case]["eager"]
        assert static["path"] == eager["path"] == "kernel"
        for e, (a, b) in enumerate(zip(static["steps"], eager["steps"])):
            _same(a, b, f"rank {rank} epoch {e}")
        _same_state(static, eager, f"rank {rank}")
        # 2 views x 2 (then 3) steps: one all-reduce each, none for the count
        assert static["reduces"] == eager["reduces"] == [4, 6], rank
    for e in (0, 1):
        _same(results[0][case]["static"]["steps"][e], results[1][case]["static"]["steps"][e],
              f"ranks, epoch {e}")
    _same_state(results[0][case]["static"], results[1][case]["static"], "ranks")


class _StepLosses:
    """The JAX trainer module's ``jnp`` with ``mean`` recording its concrete
    arguments: ``train_epoch`` returns the mean of its per-step losses, and
    this keeps them."""

    def __init__(self, jnp):
        self._jnp, self.seen = jnp, []

    def __getattr__(self, name):
        return getattr(self._jnp, name)

    def mean(self, x, *args, **kw):
        import jax

        if not isinstance(x, jax.core.Tracer):
            self.seen.append(np.asarray(x))
        return self._jnp.mean(x, *args, **kw)


def test_static_mesh_body_matches_the_jax_mesh_trainer(ranks, monkeypatch):
    """The static body on two Gloo ranks against the JAX
    ``Trainer(mesh=make_mesh(2))`` (its ``shard_map`` kernel step in
    interpret mode) from the same init, jitter off, a ragged masked tail:
    each step's loss within rel 1e-4, the bound of
    ``test_trainer_mesh_matches_the_jax_mesh_trainer``."""
    import nerf_fewshot_tpu.training.trainer as jax_trainer_mod
    from nerf_fewshot_tpu.data import lego_like_scene as jax_scene
    from nerf_fewshot_tpu.data import make_scene_dataset as jax_make_scene
    from nerf_fewshot_tpu.parallel import make_mesh
    from nerf_fewshot_tpu.training import config as jcfg

    monkeypatch.setattr(jax_trainer_mod, "FORCE_INTERPRET_KERNELS", True)
    orig = jax_trainer_mod.Trainer._render_settings
    monkeypatch.setattr(jax_trainer_mod.Trainer, "_render_settings",
                        lambda self, n, training: orig(self, n, False))
    recorded = _StepLosses(jax_trainer_mod.jnp)
    monkeypatch.setattr(jax_trainer_mod, "jnp", recorded)
    params, results = ranks
    cfg = _config(rendering={"chunk_size": 128}, optimizer={"lr_milestones": []}, **JAX_MESH)
    train = jax_make_scene(jax_scene(), 2, img_size=RES, gt_samples=32)
    jtr = jax_trainer_mod.Trainer(jcfg.config_from_dict(cfg), train, mesh=make_mesh(2))
    assert jtr._kernel_eligible()
    for k, v in params.items():  # the ranks start from this init
        for name, leaf in v.items():
            np.testing.assert_array_equal(np.asarray(jtr.params[k][name]), leaf)
    got = results[0]["jax_mesh"]
    assert got["path"] == "kernel"
    for e in (0, 1):
        want = jtr.train_epoch(e)
        steps = recorded.seen[-1].reshape(-1)
        assert steps.shape == got["steps"][e].shape == (4,)
        np.testing.assert_allclose(float(np.mean(steps)), want, rtol=1e-6)
        np.testing.assert_allclose(got["steps"][e], steps, rtol=1e-4, err_msg=f"epoch {e}")


def test_step_modes_of_a_gloo_mesh_the_plain_path_and_the_cpu(ranks):
    """A kernel-path trainer on a Gloo mesh steps eagerly because Gloo's
    collectives cannot be captured; a plain-path one under the mesh because
    of the plain path (and its static body is refused); a trainer with no
    mesh on the CPU because the CPU has no CUDA graph."""
    _, results = ranks
    for r in results:
        mode, reason = r["baseline"]["eager"]["mode"]
        assert mode == "eager" and reason.startswith("a gloo mesh:"), reason
        assert "cannot be captured" in reason
        assert r["plain"]["mode"] == ("eager", "the plain path (rendering.backend: xla)")
        assert "kernel path" in r["plain"]["refused"]
    tr = _trainer(None, _config())
    tr.epoch_steps(0)
    assert (tr.step_mode, tr.step_mode_reason) == ("eager", "no CUDA graph on cpu")


def test_the_local_valid_ray_count_equals_the_all_reduced_one(ranks):
    """The mesh step takes the valid-ray count from the whole batch's mask,
    which every rank holds, instead of all-reducing the shards' counts:
    over masks of 48 to 8,192 rays with 0 to all valid, the two are
    bit-equal on both ranks."""
    _, results = ranks
    for r in results:
        assert len(r["counts"]) == 20
        for local, reduced in r["counts"]:
            _same(local, reduced, "count")


def test_the_mesh_step_pads_its_batch_to_the_world_size(ranks):
    """Phase 0's batch of 47 rays becomes 48 under two ranks (each takes 24
    rows), as in the eager mesh step and the JAX trainer
    (``trainer.py:581-583``): 64 rays a view make 2 steps a view; phase 1's
    96 stays; the losses are finite."""
    _, results = ranks
    for r in results:
        assert r["baseline"]["static"]["batches"] == [48, 96]
        steps = r["baseline"]["static"]["steps"]
        assert [len(s) for s in steps] == [4, 6]
        assert all(np.isfinite(s).all() for s in steps)


@pytest.mark.parametrize("case", list(CASES))
def test_a_dropped_mesh_trainer_is_freed_by_reference_counting(ranks, case):
    """Each case's mesh trainer, once its step body ran, is freed by
    reference counting when dropped (the garbage collector off): nothing
    of the step (the mesh step's closure over the DINO sampler, bound to
    the trainer, once was) holds a cycle through it. On a card such a
    cycle kept the trainer's CUDA graphs alive, and NCCL's communicator
    waits for every graph that captured one of its collectives: the
    group's teardown never returned at world 2."""
    _, results = ranks
    assert [r[case]["freed"] for r in results] == [True, True]


class _Cycle:
    def __init__(self):
        self.me = self


def _raise_holding(holder):
    raise RuntimeError(f"a failure with {holder} in its frame")


def test_shutdown_frees_what_a_cycle_or_a_failure_holds_before_the_group_goes(monkeypatch):
    """``mesh.shutdown`` destroys the process group only after an object
    held in a reference cycle, and one held by the frames of an exception
    in flight (``shutdown`` called from a ``finally``), are freed: on NCCL
    either could be a graph that keeps the communicator from being
    destroyed. One Gloo rank in this process."""
    seen = []
    destroy = dist.destroy_process_group

    def checked(*args, **kw):
        seen.append([w() is None for w in watched])
        return destroy(*args, **kw)

    monkeypatch.setattr(dist, "destroy_process_group", checked)
    for failing in (False, True):
        pmesh.initialize_multihost(f"localhost:{pmesh.free_port()}", 1, 0, backend="gloo",
                                   device="cpu")
        try:
            c = _Cycle()
            watched = [weakref.ref(c)]
            del c
            if failing:
                held = _Cycle.__new__(_Cycle)  # no cycle: only the frames hold it
                watched.append(weakref.ref(held))
                with pytest.raises(RuntimeError):
                    try:
                        _raise_holding(held)
                    finally:
                        del held
                        pmesh.shutdown()
            else:
                pmesh.shutdown()
        finally:
            if dist.is_initialized():
                destroy()
    assert seen == [[True], [True, True]]
