"""Data parallelism of the port (``nerf_fewshot_tpu_torch/parallel/``) on
the CPU, against the JAX package's on its virtual CPU devices.

The port's ranks are processes over Gloo. One ``parallel.mesh.launch`` of
two ranks runs every rank job of this file (the DP objective,
``data_parallel_train_step``, the world-2 trainers, the ranks of ``cli
train --data-parallel``: ``_jobs``) and the tests read its results; the harnesses and
``cli train --multihost`` run as subprocesses, as ``tests/test_multihost.py``
runs the JAX ones. The JAX package is imported inside the tests only, so
the spawned ranks load torch and the port alone. Every spawned run has a
timeout.

Shapes: 64 rays x 8 samples and a 2 x 128 trunk for the objective (those of
``tests/test_fused_dp.py``); 16x16 views with ragged, masked batch tails for
the trainers. Tolerances are stated per test.
"""

import argparse
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from nerf_fewshot_tpu_torch import cli
from nerf_fewshot_tpu_torch.data.synthetic import lego_like_scene, make_scene_dataset
from nerf_fewshot_tpu_torch.models.mlp import NeRFMLP
from nerf_fewshot_tpu_torch.parallel import mesh as pmesh
from nerf_fewshot_tpu_torch.parallel.fused_dp import make_dp_fused_loss_grad
from nerf_fewshot_tpu_torch.render.pipeline import RenderSettings, render_rays
from nerf_fewshot_tpu_torch.training import config as tcfg
from nerf_fewshot_tpu_torch.training.losses import nerf_loss
from nerf_fewshot_tpu_torch.training.trainer import Trainer, _feature_sampler

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R, S, HIDDEN, NL = 64, 8, 128, 2
POS_FREQ, DIR_FREQ = 6, 2
FEAT_DIM, FOCAL, IMG = 64, 50.0, 64
RES = 16
TIMEOUT = 240  # seconds for any spawned run


def _objective_inputs():
    """The rays, targets, a ~20 % invalid mask, a feature map and its pose."""
    rng = np.random.default_rng(41)
    ro = rng.standard_normal((R, 3)).astype(np.float32)
    rd = rng.standard_normal((R, 3)).astype(np.float32)
    tgt = rng.uniform(0, 1, (R, 3)).astype(np.float32)
    mask = (rng.uniform(0, 1, (R,)) > 0.2).astype(np.float32)
    feat_map = rng.standard_normal((14, 14, FEAT_DIM)).astype(np.float32)
    pose = np.eye(4, dtype=np.float32)
    pose[2, 3] = 4.0
    return ro, rd, tgt, mask, feat_map, pose


def _builder(feat_map, pose):
    return _feature_sampler(feat_map, pose, FOCAL, IMG, IMG, align_corners=True)


def _small_mlp():
    return NeRFMLP(pos_freq=4, dir_freq=2, use_viewdirs=True, hidden_dim=32, num_layers=2,
                   generator=torch.Generator().manual_seed(0))


def _mse_loss(model):
    settings = RenderSettings(near=2.0, far=6.0, n_samples=S, perturb=False)
    return lambda o, d, t: torch.mean((render_rays(model, o, d, settings).rgb - t) ** 2)


def _trainer_config(**over):
    d = {
        "experiment": {"name": "port-dp"},
        "data": {"resolution": RES, "num_views": 2},
        "nerf_model": {"pos_freq": 10, "dir_freq": 4, "hidden_dim": 128, "num_layers": 3,
                       "sigma_bias": 0.1},
        # phase 0: 8x8 rays per view in batches of 48 (ragged tail of 32);
        # phase 1: 16x16 in batches of 96 (ragged tail of 32)
        "training": {"epochs": 2, "phases": [
            {"start": 0, "end": 1, "H": 8, "n_samples": 8, "batch_size": 48},
            {"start": 1, "H": RES, "n_samples": 12, "batch_size": 96}]},
        "optimizer": {"lr": 5e-4, "weight_decay": 1e-6},
        "rendering": {"chunk_size": 128},
        "output": {"save_dir": "unused", "val_freq": 1000, "save_freq": 1000},
        "seed": 0,
    }
    for k, v in over.items():
        d[k] = {**d.get(k, {}), **v}
    return d


MODULE = dict(model={"use_dino": True, "dino_model_type": "multi_scale"},
              nerf_model={"pos_freq": 4, "dir_freq": 2, "hidden_dim": 32, "num_layers": 2,
                          "arch": "module"},
              optimizer={"lr": 1e-3, "weight_decay": 1e-6, "kind": "adamw", "grad_clip": 1.0})
DINO_LORA = dict(model={"use_dino": True, "dino_model_type": "single_scale"},
                 nerf_model={"pos_freq": 10, "dir_freq": 4, "hidden_dim": 128, "num_layers": 3,
                             "sigma_bias": 0.1, "lora_rank": 4},
                 optimizer={"lr": 5e-4, "weight_decay": 1e-6, "lora_only_after_epoch": 1})
WORLD_CASES = {
    # DINO conditioning sampled on each rank's shard, the two-phase freeze at 1
    "kernel_dino_lora": (DINO_LORA, "kernel"),
    "kernel_hierarchical": ({"rendering": {"chunk_size": 128, "n_importance": 8}}, "kernel"),
    # the multiscale trainer's surface: invalid_fill mean over the whole batch
    "module": (MODULE, "plain"),
}
# one phase of 64 rays per view in batches of 48 (ragged tail of 32)
JAX_MESH_CONFIG = {"training": {"epochs": 2, "phases": [
    {"start": 0, "H": 8, "n_samples": 8, "batch_size": 48}]}}


def _case_feats(case):
    """The per-view feature maps a world case conditions on, or None."""
    dim = {"module": 128, "kernel_dino_lora": 64}.get(case)
    if dim is None:
        return None
    return np.random.default_rng(4).standard_normal((2, 4, 4, dim)).astype(np.float32)


# ------------------------------------------------------------- rank jobs


def _objective_job(mesh, states, inputs):
    """``make_dp_fused_loss_grad`` on this rank's rows, without and with
    point features."""
    ro, rd, tgt, mask, feat_map, pose = (torch.from_numpy(a) for a in inputs)
    rows = pmesh.process_local_slice(R, mesh)
    settings = RenderSettings(near=2.0, far=6.0, n_samples=S, perturb=False)
    out = {}
    for name, builder, feat in (("plain", None, ()), ("features", _builder, (feat_map, pose))):
        fn = make_dp_fused_loss_grad(mesh, settings, POS_FREQ, DIR_FREQ, NL, HIDDEN,
                                     point_features_builder=builder)
        loss, grads = fn(states[name], None, ro[rows], rd[rows], tgt[rows], mask[rows], *feat)
        out[name] = (float(loss), {k: v.numpy() for k, v in grads.items()})
    return out


def _step_job(mesh, inputs):
    """One ``data_parallel_train_step`` (Adam, lr 1e-3) of the plain
    render's mean squared error on this rank's rows."""
    model = _small_mlp()
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    step = pmesh.data_parallel_train_step(_mse_loss(model), opt, mesh)
    loss = step(*(pmesh.shard_batch(mesh, torch.from_numpy(x)) for x in inputs[:3]))
    return float(loss), {k: v.detach().numpy() for k, v in model.state_dict().items()}


def _train_job(mesh, cfg_dict, state, jitter, feats):
    """Two epochs of the port's trainer (``mesh`` None: on one device) from
    ``state`` (or its own init), the stratified jitter on or off; the
    per-step losses of each epoch and the parameters after them."""
    data = make_scene_dataset(lego_like_scene(), 2, img_size=RES, gt_samples=32, device="cpu")
    tr = Trainer(tcfg.config_from_dict(cfg_dict), data, device="cpu", mesh=mesh,
                 dino_features=feats)
    if state is not None:
        tr.model.load_state_dict(state)
    if not jitter:
        orig = tr._render_settings
        tr._render_settings = lambda n, training: orig(n, False)
    steps = []
    for e in (0, 1):
        tr.train_epoch(e)
        steps.append(tr.last_step_losses)
    return {"path": tr.kernel_path, "steps": steps,
            "params": {k: v.numpy() for k, v in tr.model.state_dict().items()}}


def _jobs(mesh, jobs):
    """The rank function: every job of ``jobs`` ({name: (function, args)})
    on this rank, in order, on one CPU thread (two ranks of these small
    shapes spend most of their time contending for the cores otherwise)."""
    torch.set_num_threads(1)
    return {name: fn(mesh, *args) for name, (fn, args) in jobs.items()}


CLI_CONFIG = """experiment:
  name: "dp-cli"
data:
  resolution: 16
  num_views: 2
nerf_model:
  pos_freq: 10
  dir_freq: 4
  hidden_dim: 128
  num_layers: 2
  sigma_bias: 0.1
training:
  epochs: 1
  batch_size: 64      # x2 before epoch 50: 128 rays per step
  progressive_schedule:
    epochs_0_50: [16, 16, 8]
    epochs_50_100: [16, 16, 8]
    epochs_100_plus: [16, 16, 8]
rendering:
  chunk_size: 256
output:
  save_dir: "{save_dir}"
  val_freq: 1000
  save_freq: 1
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The JAX inits the rank jobs start from (numpy trees), the inputs, the
    ``--data-parallel`` run's directory and the two ranks' job results."""
    import jax
    import jax.numpy as jnp

    from nerf_fewshot_tpu.models import NeRFMLP as JNeRFMLP
    from nerf_fewshot_tpu_torch.models.mlp import nerf_mlp_from_jax

    params = {}
    for name, dino, bias, hidden, layers, key in (
            ("plain", 0, 0.0, HIDDEN, NL, jax.random.key(0)),
            ("features", FEAT_DIM, 0.3, HIDDEN, NL, jax.random.key(0)),
            # the JAX trainer's init at seed 0 (trainer.py:160-175)
            ("trainer", 0, 0.1, 128, 3, jax.random.split(jax.random.key(0))[0])):
        model = JNeRFMLP(pos_freq=10 if name == "trainer" else POS_FREQ,
                         dir_freq=4 if name == "trainer" else DIR_FREQ, use_viewdirs=True,
                         hidden_dim=hidden, num_layers=layers, dino_dim=dino,
                         sigma_bias_init=bias)
        args = (jnp.zeros((1, 3)), jnp.zeros((1, 3))) + ((jnp.zeros((1, dino)),) if dino else ())
        params[name] = jax.tree_util.tree_map(
            np.asarray, jax.jit(model.init)(key, *args)["params"])
    states = {k: nerf_mlp_from_jax(v) for k, v in params.items()}
    inputs = _objective_inputs()

    out_dir = tmp_path_factory.mktemp("dp_cli")
    config = out_dir / "dp.yaml"
    config.write_text(CLI_CONFIG.format(save_dir=out_dir / "out"))
    cli_args = argparse.Namespace(config=str(config), epochs=None, resume=None, synthetic=True,
                                  data_parallel=True, multihost=False, profile=None,
                                  nan_guard=False, wandb=False, device="cpu")
    jobs = {"objective": (_objective_job, ({k: states[k] for k in ("plain", "features")},
                                           inputs)),
            "step": (_step_job, (inputs,)),
            **{f"world_{case}": (_train_job, (_trainer_config(**over), None, True,
                                             _case_feats(case)))
               for case, (over, _) in WORLD_CASES.items()},
            **{f"jax_mesh_{b}": (_train_job, (
                _trainer_config(rendering={"chunk_size": 128, "backend": b}, **JAX_MESH_CONFIG),
                states["trainer"], False, None)) for b in ("auto", "xla")},
            "cli": (cli._train_rank, (cli_args,))}
    results = pmesh.launch(_jobs, ["cpu", "cpu"], (jobs,), timeout_s=TIMEOUT)
    return params, inputs, out_dir, results


# ------------------------------------------------------------------ tests


@pytest.mark.parametrize("case", ["plain", "features"])
def test_dp_fused_loss_grad_matches_jax(ranks, case):
    """World 2 (Gloo, the kernel's plain version) against the JAX
    ``make_dp_fused_loss_grad`` on ``make_mesh(2)`` (its kernel in interpret
    mode), ``perturb`` off: loss rel 1e-5, each gradient rel 1e-4 (atol
    1e-6, as ``tests/test_fused_dp.py``); both ranks bit-equal."""
    import jax

    from nerf_fewshot_tpu.parallel import make_mesh
    from nerf_fewshot_tpu.parallel.fused_dp import make_dp_fused_loss_grad as jax_dp
    from nerf_fewshot_tpu.render.pipeline import RenderSettings as JSettings
    from nerf_fewshot_tpu.training.trainer import _feature_sampler as jax_sampler
    from nerf_fewshot_tpu_torch.models.mlp import nerf_mlp_from_jax

    params, (ro, rd, tgt, mask, feat_map, pose), _, results = ranks
    builder = None
    feat = ()
    if case == "features":
        feat = (feat_map, pose)
        builder = lambda fm, fp: jax_sampler(fm, fp, FOCAL, IMG, IMG, align_corners=True)
    fn = jax.jit(jax_dp(make_mesh(2), JSettings(near=2.0, far=6.0, n_samples=S, perturb=False),
                        POS_FREQ, DIR_FREQ, NL, HIDDEN, interpret=True,
                        point_features_builder=builder))
    want_loss, want_grads = fn(params[case], jax.random.key(1), ro, rd, tgt, mask, *feat)
    want = nerf_mlp_from_jax(jax.tree_util.tree_map(np.asarray, want_grads))
    (loss0, grads0), (loss1, grads1) = (r["objective"][case] for r in results)
    assert loss0 == loss1 and all(np.array_equal(grads0[k], grads1[k]) for k in grads0)
    np.testing.assert_allclose(loss0, float(want_loss), rtol=1e-5)
    assert set(grads0) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(grads0[k], w.numpy(), rtol=1e-4, atol=1e-6, err_msg=k)


def test_data_parallel_train_step_matches_one_device(ranks):
    """One Adam step of the plain render's mean squared error, the batch
    split over two ranks (gradients averaged), against the same step on the
    whole batch in one process: loss rel 1e-5, parameters rel 1e-4 (atol
    1e-6), both ranks bit-equal."""
    _, inputs, _, results = ranks
    ro, rd, tgt = (torch.from_numpy(a) for a in inputs[:3])
    model = _small_mlp()
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    loss = _mse_loss(model)(ro, rd, tgt)
    loss.backward()
    opt.step()
    (l0, p0), (l1, p1) = (r["step"] for r in results)
    assert l0 == l1 and all(np.array_equal(p0[k], p1[k]) for k in p0)
    np.testing.assert_allclose(l0, loss.item(), rtol=1e-5)
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(p0[k], v.numpy(), rtol=1e-4, atol=1e-6, err_msg=k)


def test_nerf_loss_with_the_global_denominator_sums_over_shards():
    """Every masked mean of the non-strict objective (rgb, w^2, depth) over
    two shards of a batch with a masked ragged tail, each divided by the
    batch's valid-ray count, sums to the batch's loss (rel 1e-6)."""
    rng = np.random.default_rng(3)
    n = 48
    pred, tgt = (torch.from_numpy(rng.uniform(0, 1, (n, 3)).astype(np.float32)) for _ in "ab")
    weights = torch.from_numpy(rng.uniform(0, 1, (n, 12)).astype(np.float32))
    depth, tdepth = (torch.from_numpy(rng.uniform(2, 6, (n,)).astype(np.float32)) for _ in "ab")
    mask = torch.ones(n)
    mask[37:] = 0.0
    cfg = tcfg.config_from_dict({"loss": {"rgb_weight": 1.0, "depth_weight": 0.1,
                                          "reg_weight": 0.01}}).loss
    full = nerf_loss(pred, tgt, cfg, depth, tdepth, weights, mask)
    assert set(full) == {"rgb", "depth", "regularization", "total"}
    denom = torch.sum(mask)
    parts = [nerf_loss(pred[s], tgt[s], cfg, depth[s], tdepth[s], weights[s], mask[s],
                       denom_rays=denom) for s in (slice(0, n // 2), slice(n // 2, n))]
    for k, v in full.items():
        np.testing.assert_allclose(float(parts[0][k] + parts[1][k]), float(v), rtol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("case", list(WORLD_CASES))
def test_world_2_matches_world_1(ranks, case):
    """Two epochs with the stratified (and importance) jitter on: the ranks
    draw the whole batch's uniforms and take their rows, so world 2 follows
    world 1 up to the order of the sums: per-step losses within rel 1e-5,
    parameters within 1e-4 (two fp32 Adam trajectories), both ranks
    bit-equal in losses and parameters. ``kernel_dino_lora`` samples DINO
    features on each rank's shard (``fused_dp``'s builder) and trains trunk
    LoRA across the two-phase freeze at epoch 1; ``kernel_hierarchical``
    draws importance uniforms too; ``module`` takes the plain path with
    ``invalid_fill: mean`` (its mean over both ranks' points) and AdamW
    with gradient clipping."""
    over, path = WORLD_CASES[case]
    one = _train_job(None, _trainer_config(**over), None, True, _case_feats(case))
    two = [r[f"world_{case}"] for r in ranks[3]]
    assert one["path"] == two[0]["path"] == path
    for e in (0, 1):
        assert np.array_equal(two[0]["steps"][e], two[1]["steps"][e])
        print(f"{case} epoch {e}: per-step max rel "
              f"{np.abs(two[0]['steps'][e] / one['steps'][e] - 1).max():.2e}")
        np.testing.assert_allclose(two[0]["steps"][e], one["steps"][e], rtol=1e-5,
                                   err_msg=f"epoch {e}")
    assert len(one["steps"][1]) == 2 * 3  # 2 views x ceil(256 / 96)
    for k, v in one["params"].items():
        assert np.array_equal(two[0]["params"][k], two[1]["params"][k]), k
        np.testing.assert_allclose(two[0]["params"][k], v, rtol=0, atol=1e-4, err_msg=k)


@pytest.mark.parametrize("backend", ["auto", "xla"])
def test_trainer_mesh_matches_the_jax_mesh_trainer(ranks, backend, monkeypatch):
    """``Trainer(mesh=world 2)`` against the JAX ``Trainer(mesh=make_mesh(2))``
    from the same transplanted init, jitter off, a ragged masked tail: the
    JAX trainer through its ``shard_map`` kernel step in interpret mode
    (``auto``) or its sharded XLA step (``xla``), the port through
    ``make_dp_fused_loss_grad`` or its plain step. Epoch losses within rel
    1e-4."""
    import nerf_fewshot_tpu.training.trainer as jax_trainer_mod
    from nerf_fewshot_tpu.data import lego_like_scene as jax_scene
    from nerf_fewshot_tpu.data import make_scene_dataset as jax_make_scene
    from nerf_fewshot_tpu.parallel import make_mesh
    from nerf_fewshot_tpu.training import config as jcfg

    monkeypatch.setattr(jax_trainer_mod, "FORCE_INTERPRET_KERNELS", True)
    orig = jax_trainer_mod.Trainer._render_settings
    monkeypatch.setattr(jax_trainer_mod.Trainer, "_render_settings",
                        lambda self, n, training: orig(self, n, False))
    cfg = _trainer_config(rendering={"chunk_size": 128, "backend": backend}, **JAX_MESH_CONFIG)
    train = jax_make_scene(jax_scene(), 2, img_size=RES, gt_samples=32)
    jtr = jax_trainer_mod.Trainer(jcfg.config_from_dict(cfg), train, mesh=make_mesh(2))
    assert jtr._kernel_eligible() == (backend == "auto")
    for k, v in ranks[0]["trainer"].items():  # the ranks start from this init
        for name, leaf in v.items():
            np.testing.assert_array_equal(np.asarray(jtr.params[k][name]), leaf)
    want = [jtr.train_epoch(e) for e in (0, 1)]
    two = ranks[3][0][f"jax_mesh_{backend}"]
    assert two["path"] == ("kernel" if backend == "auto" else "plain")
    np.testing.assert_allclose([float(np.mean(s)) for s in two["steps"]], want, rtol=1e-4)


def test_cli_data_parallel_ranks(ranks):
    """The ranks of ``cli train --data-parallel`` (``_train_rank``, one per
    card), here two CPU ranks over Gloo: the same summary on both; rank 0
    writes the run's files, rank 1 none into ``output.save_dir``."""
    out_dir, results = ranks[2], ranks[3]
    assert results[0]["cli"] == results[1]["cli"]
    assert results[0]["cli"]["final_metrics"]["kernel_path"] == "kernel"
    files = sorted(os.listdir(out_dir / "out"))
    assert files == ["epoch_1.ckpt", "epoch_1.ckpt.json", "final.ckpt", "final.ckpt.json",
                     "log.jsonl"]
    lines = (out_dir / "out" / "log.jsonl").read_text().splitlines()
    assert sum('"train_loss"' in x for x in lines) == 1  # one writer


def _run_ranks(argvs, env_of=None, cwd_of=None):
    """Start one process per argv (one CPU thread each), wait for all with
    a timeout, assert each exited 0, and return their outputs."""
    procs = [subprocess.Popen(argv, cwd=cwd_of(i) if cwd_of else ROOT,
                              env={**os.environ, "OMP_NUM_THREADS": "1",
                                   **(env_of(i) if env_of else {})},
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for i, argv in enumerate(argvs)]
    try:
        outs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {i} exited {p.returncode}:\n{out}"
    return outs


@pytest.mark.parametrize("module,flags,pattern", [
    ("multihost_smoke", [], r"devices=2 loss=[0-9.]+"),
    ("multihost_train_smoke", ["--kernels"], r"devices=2 kernel=fused losses=[0-9.,]+"),
], ids=["smoke", "train_smoke"])
def test_two_process_harnesses(module, flags, pattern):
    """Each harness as two processes on the CPU (Gloo): ``multihost_smoke``
    on its plain route (``data_parallel_train_step``),
    ``multihost_train_smoke`` with ``--kernels`` (the trainer's step through
    ``make_dp_fused_loss_grad``). Both processes exit 0 and print the JAX
    harness's line, with equal losses."""
    address = f"localhost:{pmesh.free_port()}"
    outs = _run_ranks([[sys.executable, "-m", f"nerf_fewshot_tpu_torch.parallel.{module}",
                        "--coordinator", address, "--num-processes", "2", "--process-id",
                        str(i), "--cpu", *flags] for i in range(2)])
    found = [re.search(pattern, out) for out in outs]
    assert all(found), outs
    assert found[0].group(0) == found[1].group(0)


def test_cli_multihost_world_2(tmp_path):
    """``cli train --multihost --device cpu`` as two ranks of a group read
    from ``MASTER_ADDR`` / ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK``: both
    print the ``[mesh]`` line and the same summary (every rank writes its
    run's files, as every JAX process does: here each in its own working
    directory)."""
    config = tmp_path / "dp.yaml"
    config.write_text(CLI_CONFIG.format(save_dir="out"))
    for i in range(2):
        (tmp_path / f"rank{i}").mkdir()
    port = str(pmesh.free_port())
    argv = [sys.executable, "-m", "nerf_fewshot_tpu_torch.cli", "train", "--config", str(config),
            "--synthetic", "--device", "cpu", "--multihost"]
    outs = _run_ranks(
        [argv, argv],
        env_of=lambda i: {"MASTER_ADDR": "localhost", "MASTER_PORT": port, "WORLD_SIZE": "2",
                          "RANK": str(i), "PYTHONPATH": ROOT},
        cwd_of=lambda i: str(tmp_path / f"rank{i}"))
    for out in outs:
        assert "[mesh] data-parallel over 2 devices across 2 processes (gloo)" in out, out
    summaries = [json.loads([x for x in out.splitlines() if x.startswith("{")][-1])
                 for out in outs]
    assert summaries[0] == summaries[1]
    assert summaries[0]["final_metrics"]["kernel_path"] == "kernel"
    for i in range(2):
        assert (tmp_path / f"rank{i}" / "out" / "final.ckpt").exists()


def test_mesh_refusals(monkeypatch):
    """No group, no coordinator, no card, NCCL on the CPU, uneven shards:
    each raises and says why."""
    with pytest.raises(RuntimeError, match="initialize_multihost first"):
        pmesh.make_mesh("cpu")
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match="coordinator_address"):
        pmesh.initialize_multihost(num_processes=1, process_id=0, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pmesh.initialize_multihost("localhost:1", 1, 0)
    with pytest.raises(RuntimeError, match="NCCL backend needs a CUDA device"):
        pmesh.initialize_multihost("localhost:1", 1, 0, backend="nccl", device="cpu")
    mesh = pmesh.Mesh(rank=1, world_size=2, device=torch.device("cpu"), backend="gloo")
    assert pmesh.process_local_slice(64, mesh) == slice(32, 64)
    with pytest.raises(ValueError, match="do not split evenly"):
        pmesh.process_local_slice(63, mesh)
