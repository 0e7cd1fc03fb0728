"""The kernel-path step that the card replays as a CUDA graph
(``training/step_graph.py``, ``Trainer._static_epoch``), its Adam kernel's
host side (``training/optim.py``: ``adam_step_scalars``, ``AdamKernel``)
and the contiguous gradient buffers (``render/kernels.py:packed_grads(out=)``,
``render/train_kernel.py:grad_buffer``), on the CPU.

The graph replays a body that reads only device buffers and a device step
index. Run as it is on the CPU (``Trainer._static_epoch_steps``), with the
Adam kernel's plain version (torch's step), that body must give the eager
steps' bits: per-step losses, parameters and Adam state, for the baseline,
hierarchical, DINO, trunk-LoRA (across its freeze) and clipped configs over
epochs that cross a phase change. The Adam kernel reads each step's
scalars from a table the host fills once per epoch: the table must hold
exactly what torch hands its foreach kernels (float64 Python expressions
cast to fp32). On the card the same body runs as graph replays and the
kernel launches: ``tests/test_torch_port_cuda.py`` (marked ``cuda``, skipped
here) and ``chip_smoke.py`` hold those bit for bit to the eager step.
"""

import jax
import numpy as np
import pytest
import torch

import nerf_fewshot_tpu.training.trainer as jax_trainer_mod
from nerf_fewshot_tpu.data import lego_like_scene as jax_scene
from nerf_fewshot_tpu.data import make_scene_dataset as jax_make_scene
from nerf_fewshot_tpu.training import config as jcfg
from nerf_fewshot_tpu_torch.data.blender import BlenderDataset
from nerf_fewshot_tpu_torch.models.mlp import NeRFMLP, nerf_mlp_from_jax
from nerf_fewshot_tpu_torch.render import kernels as tk
from nerf_fewshot_tpu_torch.render import train_kernel as tt
from nerf_fewshot_tpu_torch.render.pipeline import RenderSettings
from nerf_fewshot_tpu_torch.training import config as tcfg
from nerf_fewshot_tpu_torch.training import optim as toptim
from nerf_fewshot_tpu_torch.training.trainer import Trainer

RES = 16
HIDDEN, N_LAYERS = 128, 3


def _bits(t: torch.Tensor) -> np.ndarray:
    a = t.detach().contiguous().numpy()
    return a.view(np.int32 if a.dtype == np.float32 else np.int64)


def _same(a, b, label=""):
    assert tuple(a.shape) == tuple(b.shape), label
    assert np.array_equal(_bits(a), _bits(b)), label


def _config(mod, kind="baseline", **over):
    d = {
        "experiment": {"name": "port-step-graph"},
        "data": {"resolution": RES, "num_views": 2},
        "nerf_model": {"pos_freq": 10, "dir_freq": 4, "hidden_dim": HIDDEN,
                       "num_layers": N_LAYERS, "sigma_bias": 0.1},
        # phase 0: 8x8 rays per view in batches of 48 (ragged tail of 32);
        # phase 1: 16x16 in batches of 96 (ragged tail of 32)
        "training": {"epochs": 3, "phases": [
            {"start": 0, "end": 1, "H": 8, "n_samples": 8, "batch_size": 48},
            {"start": 1, "H": RES, "n_samples": 12, "batch_size": 96}]},
        "optimizer": {"lr": 5e-4, "weight_decay": 1e-6, "lr_milestones": [1]},
        "rendering": {"chunk_size": 96},
        "seed": 0,
    }
    if kind == "hierarchical":
        d["rendering"]["n_importance"] = 6
    if kind == "lora":
        d["nerf_model"]["lora_rank"] = 4
        d["optimizer"]["lora_only_after_epoch"] = 1
    if kind == "dino":
        d["model"] = {"use_dino": True, "dino_model_type": "single_scale"}
        d["nerf_model"]["pos_freq"] = 12
    if kind == "clip":
        d["optimizer"]["grad_clip"] = 0.05
    for k, v in over.items():
        d[k] = {**d.get(k, {}), **v}
    return mod.config_from_dict(d)


@pytest.fixture(scope="module")
def scene():
    train = jax_make_scene(jax_scene(), 2, img_size=RES, gt_samples=32)
    test = jax_make_scene(jax_scene(), 2, img_size=RES, gt_samples=32, split="test")
    return train, test


def _port_data(ds):
    return BlenderDataset(np.asarray(ds.images), np.asarray(ds.poses), ds.H, ds.W, ds.focal)


def _trainer(scene, kind="baseline", **over):
    train, test = scene
    feats = None
    if kind == "dino":
        feats = np.random.default_rng(4).standard_normal((2, 3, 3, 64)).astype(np.float32)
    return Trainer(_config(tcfg, kind, **over), _port_data(train), _port_data(test),
                   device="cpu", dino_features=feats)


def _expected_row(lr, wd, step):
    """torch's ``_multi_tensor_adam`` scalars of step ``step``, each a
    float64 Python expression cast to fp32 as torch casts a scalar."""
    row = ((lr / (1 - 0.9 ** step)) * -1, (1 - 0.999 ** step) ** 0.5, 1 - lr * wd)
    for x in row:  # torch's cast of a Python scalar is to nearest, as numpy's
        assert torch.tensor(x, dtype=torch.float32).item() == float(np.float32(x))
    return np.asarray(row, np.float32)


# ------------------------------------------------------- the Adam scalar table

@pytest.mark.parametrize("start,lr", [(0, 5e-4), (37, 2.5e-4), (1234, 1.25e-4)])
def test_adam_scalar_table_is_torchs_float64_cast(start, lr):
    """Steps ``start + 1 ..`` of the table at a learning rate: a fresh
    optimizer, one past a milestone (lr halved), one at a JAX checkpoint's
    count; every entry the fp32 cast of the float64 expression."""
    model = NeRFMLP(hidden_dim=HIDDEN, num_layers=N_LAYERS,
                    generator=torch.Generator().manual_seed(0))
    opt = toptim.make_optimizer(tcfg.OptimizerConfig(lr=5e-4, weight_decay=1e-6),
                                model.parameters(), clip_hook=False)
    toptim.init_adam_state(opt)
    for p in opt.param_groups[0]["params"]:
        opt.state[p]["step"] += start
    toptim.set_learning_rate(opt, lr)
    table = toptim.adam_step_scalars(opt, 7)
    assert table.dtype == np.float32 and table.shape == (7, toptim.SCALARS_PER_STEP)
    for k in range(7):
        _same(torch.from_numpy(table[k]), torch.from_numpy(_expected_row(lr, 1e-6, start + k + 1)))


def test_adam_scalar_table_follows_the_trainer_across_a_milestone_and_the_freeze(scene):
    """The trainer's static step fills the table once per epoch from the
    step count and the epoch's lr: across the milestone at epoch 1 and the
    LoRA freeze there (a fresh optimizer: the count starts at 1 again), and
    on into epoch 2."""
    tr = _trainer(scene, "lora")
    done = 0
    for epoch in (0, 1, 2):
        tr._static_epoch_steps(epoch)
        adam = tr._static.adam
        n = tr._static.n_steps
        start = 0 if epoch == 1 else done
        want = np.stack([_expected_row(tr.lr_at(epoch), 1e-6, start + k + 1) for k in range(n)])
        _same(adam.scalars[:n], torch.from_numpy(want), f"epoch {epoch}")
        assert int(adam.counter[0]) == n
        done = start + n
    assert tr._lora_only_active and tr.lr_at(1) == 2.5e-4
    assert all(float(tr.optimizer.state[p]["step"]) == 2 * tr._static.n_steps
               for p in tr.optimizer.param_groups[0]["params"])


# ---------------------------------------------------- the static-buffer step

@pytest.mark.parametrize("kind", ["baseline", "hierarchical", "dino", "lora", "clip"])
def test_static_body_is_bit_equal_to_the_eager_steps(scene, kind):
    """Epochs 0 and 1 (a phase change, the lr milestone and the LoRA freeze
    at 1; jitter on, ragged tails): the static-buffer body run as it is
    against ``epoch_steps``' eager steps, the CPU path: per-step losses,
    parameters and Adam state (both moments, the step) bit-equal."""
    static, eager = _trainer(scene, kind), _trainer(scene, kind)
    for epoch in (0, 1):
        _same(static._static_epoch_steps(epoch), eager.epoch_steps(epoch), f"epoch {epoch}")
    assert eager.step_mode == "eager" and eager.step_mode_reason == "no CUDA graph on cpu"
    sa, sb = static.model.state_dict(), eager.model.state_dict()
    for k in sa:
        _same(sa[k], sb[k], k)
    oa, ob = static.optimizer.state_dict()["state"], eager.optimizer.state_dict()["state"]
    assert sorted(oa) == sorted(ob) and oa
    for i in oa:
        for key in ("step", "exp_avg", "exp_avg_sq"):
            _same(oa[i][key], ob[i][key], (i, key))


def _no_jitter(monkeypatch, cls):
    orig = cls._render_settings
    monkeypatch.setattr(cls, "_render_settings", lambda self, n, training: orig(self, n, False))


def test_static_body_matches_the_jax_trainer(scene, monkeypatch):
    """The static-buffer body against the JAX trainer's one-dispatch epoch
    (its train kernel in interpret mode) from the same transplanted init,
    jitter off on both sides: the tolerances of
    ``test_torch_port_train_trainer.py``'s epoch test (epoch losses rtol
    1e-4; the parameter change as one vector within rel 2e-3, each
    parameter within 1e-4)."""
    monkeypatch.setattr(jax_trainer_mod, "FORCE_INTERPRET_KERNELS", True)
    _no_jitter(monkeypatch, jax_trainer_mod.Trainer)
    _no_jitter(monkeypatch, Trainer)
    train, test = scene
    over = {"optimizer": {"lr_milestones": []}, "rendering": {"chunk_size": 128}}
    jtr = jax_trainer_mod.Trainer(_config(jcfg, **over), train, test)
    assert jtr._kernel_eligible()
    ptr = Trainer(_config(tcfg, **over), _port_data(train), _port_data(test), device="cpu")
    ptr.load_jax_params(jax.tree_util.tree_map(np.asarray, jtr.params))
    start = {k: v.clone() for k, v in ptr.model.state_dict().items()}
    for epoch in (0, 1):
        want = jtr.train_epoch(epoch)
        got = float(np.mean(ptr._static_epoch_steps(epoch).numpy()))
        np.testing.assert_allclose(got, want, rtol=1e-4)
    want = nerf_mlp_from_jax(jax.tree_util.tree_map(np.asarray, jtr.params))
    got = ptr.model.state_dict()
    for k in start:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0, atol=1e-4, err_msg=k)
    dg = torch.cat([(got[k] - start[k]).reshape(-1) for k in start]).double()
    dw = torch.cat([(want[k] - start[k]).reshape(-1) for k in start]).double()
    assert dw.norm() > 0 and ((dg - dw).norm() / dw.norm()).item() < 2e-3


# ------------------------------------------------- the contiguous gradients

@pytest.mark.parametrize("case", ["inline_pe", "encoded_x", "lora"])
def test_contiguous_gradients_equal_the_kernels_layouts(case):
    """``fused_train_loss_grad(grad_buffer=)`` writes every gradient into
    the flat buffer, contiguous in its parameter's shape (``grad_buffer``'s
    views): value for value and bit for bit the gradients it returns as the
    kernel gave them (transposed views of the packed gradients with the +0.0
    of ``w0``'s row gather, or autograd's through the LoRA merge)."""
    g = torch.Generator().manual_seed(0)
    model = NeRFMLP(use_viewdirs=True, hidden_dim=HIDDEN, num_layers=N_LAYERS,
                    sigma_bias_init=0.1, lora_rank=4 if case == "lora" else 0, generator=g)
    if case == "lora":
        with torch.no_grad():
            for name, p in model.named_parameters():
                if "lora_b" in name:
                    p.copy_(torch.randn(p.shape, generator=g) * 0.1)
    R, S = 24, 16
    rays_o = torch.tensor([[0.0, 0.0, 4.0]]).expand(R, 3).contiguous()
    d = torch.randn(R, 3, generator=g)
    d[:, 2] = -d[:, 2].abs() - 1.0
    mask = torch.ones(R)
    mask[-5:] = 0.0
    flat, views = tt.grad_buffer(dict(model.named_parameters()), N_LAYERS)
    loss, grads = tt.fused_train_loss_grad(
        model, rays_o, d, torch.rand(R, 3, generator=g), mask,
        RenderSettings(near=2.0, far=6.0, n_samples=S, perturb=True), 10, 4, N_LAYERS, HIDDEN,
        uniforms=torch.rand(R, S, generator=g), inline_pe=case != "encoded_x",
        grad_buffer=flat)
    assert set(views) == set(grads) == set(dict(model.named_parameters()))
    transposed = 0
    for name, v in views.items():
        assert v.is_contiguous() and v.data_ptr() >= flat.data_ptr()
        _same(v, grads[name], name)
        transposed += not grads[name].is_contiguous()
    assert transposed > 0  # the layouts the buffers leave behind
    assert torch.isfinite(loss)


def test_packed_grads_into_a_buffer_keeps_the_sign_of_zeros():
    """``packed_grads(out=)`` from the kernels' flat buffer (as they return
    their gradients: views of one buffer) and from separate tensors (the
    plain version's): bit-equal to ``packed_grads``' views, a -0.0 in
    ``w0``'s packed gradient turned +0.0 as ``_unpack`` turns it."""
    model = NeRFMLP(use_viewdirs=True, hidden_dim=HIDDEN, num_layers=N_LAYERS,
                    generator=torch.Generator().manual_seed(0))
    params = dict(model.named_parameters())
    consts = tk.pe_constants(10, 4, True, 0, "cpu")
    d_pad = tk.pe_width(consts.x_dim)
    packed = tk.pack_params(params, N_LAYERS, HIDDEN, d_pad=d_pad, row_perm=consts.row_perm)
    g = torch.Generator().manual_seed(1)
    flat_in = torch.cat([torch.randn(p.numel(), generator=g) for p in packed])
    dpacked = tk._split_grads(flat_in, packed)
    dpacked[0][int(consts.row_perm.argsort()[0]), 0] = -0.0
    want = tk.packed_grads(params, N_LAYERS, HIDDEN, d_pad, consts.row_perm, dpacked)
    assert tk._flat_of(dpacked) is flat_in
    for source in (dpacked, tuple(t.clone() for t in dpacked)):
        out = torch.full((sum(p.numel() for p in params.values()),), float("nan"))
        got = tk.packed_grads(params, N_LAYERS, HIDDEN, d_pad, consts.row_perm, source, out=out)
        assert list(got) == list(want)
        for k in want:
            _same(got[k], want[k], k)
    assert _bits(got["trunk.0.weight"])[0, 0] == 0  # +0.0
    with pytest.raises(ValueError, match="contiguous flat buffer"):
        tk.packed_grads(params, N_LAYERS, HIDDEN, d_pad, consts.row_perm, dpacked,
                        out=torch.empty(3))


# ------------------------------------------------------- checkpoints, modes

def test_save_and_load_round_trip_the_static_steps_optimizer_state(scene, tmp_path):
    """A trainer stepped through the static body saves; a fresh one loads:
    the optimizer state bit-equal, and epoch 2 (a new Adam kernel over the
    loaded moments) bit-equal on both."""
    a = _trainer(scene)
    for epoch in (0, 1):
        a._static_epoch_steps(epoch)
    a.epoch = 1
    a.save(str(tmp_path / "a.ckpt"))
    b = _trainer(scene)
    b.load(str(tmp_path / "a.ckpt"))
    sa, sb = a.optimizer.state_dict()["state"], b.optimizer.state_dict()["state"]
    for i in sa:
        for key in ("step", "exp_avg", "exp_avg_sq"):
            _same(sa[i][key], sb[i][key], (i, key))
    b._np_rng.bit_generator.state = a._np_rng.bit_generator.state
    b._generator.set_state(a._generator.get_state())
    _same(a._static_epoch_steps(2), b._static_epoch_steps(2))


def test_a_jax_checkpoint_loads_its_moments_into_the_static_step(scene, tmp_path):
    """A JAX package checkpoint (two epochs of the JAX trainer: 4 + 6
    steps) loads into two trainers; epoch 2 through the static body and
    through the eager steps is bit-equal (the loaded moments are the ones
    the body's first step reads), and the body's table continues from the
    JAX count."""
    over = {"optimizer": {"lr_milestones": []}, "rendering": {"chunk_size": 128}}
    train, test = scene
    jtr = jax_trainer_mod.Trainer(_config(jcfg, **over), train, test)
    for e in (0, 1):
        jtr.epoch = e
        jtr.train_epoch(e)
    path = str(tmp_path / "jax.ckpt")
    jtr.save(path)
    static, eager = (Trainer(_config(tcfg, **over), _port_data(train), _port_data(test),
                             device="cpu") for _ in range(2))
    for tr in (static, eager):
        tr.load(path)
        tr._np_rng.bit_generator.state = jtr._np_rng.bit_generator.state
        assert {float(tr.optimizer.state[p]["step"])
                for p in tr.optimizer.param_groups[0]["params"]} == {10.0}
    _same(static._static_epoch_steps(2), eager.epoch_steps(2))
    _same(static._static.adam.scalars[0], torch.from_numpy(_expected_row(5e-4, 1e-6, 11)))
    for (k, a), b in zip(static.model.state_dict().items(), eager.model.state_dict().values()):
        _same(a, b, k)


def test_step_modes_record_why_a_trainer_steps_eagerly(scene):
    """On the CPU every trainer steps eagerly and says why: the kernel
    path's reason is the device, the plain path's is the plain path."""
    kernel, plain = _trainer(scene), _trainer(scene, rendering={"backend": "xla"})
    for tr in (kernel, plain):
        tr.epoch_steps(0)
        assert tr.step_mode == "eager"
    assert kernel.step_mode_reason == "no CUDA graph on cpu"
    assert plain.step_mode_reason == "the plain path (rendering.backend: xla)"
    with pytest.raises(ValueError, match="kernel path"):
        plain._static_epoch_steps(1)


def test_adam_kernel_runs_its_plain_version_on_the_cpu():
    """``AdamKernel.step`` on CPU tensors is torch's step (and the counter
    moves on); no kernel launch is counted; it refuses what the kernel does
    not take: another optimizer, a clip hook, a non-contiguous gradient."""
    model = NeRFMLP(hidden_dim=HIDDEN, num_layers=N_LAYERS,
                    generator=torch.Generator().manual_seed(0))
    params = list(model.parameters())
    cfg = tcfg.OptimizerConfig(lr=5e-4, weight_decay=1e-6)
    grads = [torch.randn(p.shape, generator=torch.Generator().manual_seed(1)) for p in params]
    for p, g in zip(params, grads):
        p.grad = g
    copies = [torch.nn.Parameter(p.detach().clone()) for p in params]
    for c, g in zip(copies, grads):
        c.grad = g.clone()
    opt = toptim.make_optimizer(cfg, params, clip_hook=False)
    adam = toptim.AdamKernel(opt, grads, 4)
    want = toptim.make_optimizer(cfg, copies, clip_hook=False)
    before = toptim.AdamKernel.launches
    adam.begin_epoch(2)
    for _ in range(2):
        adam.step()
        want.step()
    adam.end_epoch(2)
    assert toptim.AdamKernel.launches == before and int(adam.counter[0]) == 2
    for p, c in zip(params, copies):
        _same(p, c)
        assert float(opt.state[p]["step"]) == 2.0
    with pytest.raises(ValueError, match="pre-hooks"):
        toptim.AdamKernel(toptim.make_optimizer(tcfg.OptimizerConfig(grad_clip=1.0), params),
                          grads, 4)
    with pytest.raises(ValueError, match="not Adam"):
        toptim.AdamKernel(torch.optim.SGD(params, lr=0.1), grads, 4)
    with pytest.raises(ValueError, match="exceed"):
        adam.begin_epoch(5)
