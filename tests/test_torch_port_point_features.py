"""The per-point feature sampler of the kernel path
(``nerf_fewshot_tpu_torch/render/point_features.py``), on the CPU.

On a card the kernel path samples each step's, eval chunk's and rank's
point features with one launch of ``csrc/point_features.cu`` over the whole
map stack, the trainer's world-to-camera stack (inverted once per view at
construction) and a view index read from the device; on the CPU the wrapper
runs its plain version. These tests hold that plain version to the JAX
trainer's ``_feature_sampler`` at edge points (behind the camera, off the
map, on pixel edges, at integer coordinates), the hoisted inverse to the
per-call one bit for bit, a CPU trainer sampling through the wrapper to the
same trainer sampling through the plain closure bit for bit, and the
wrapper's refusals. The kernel itself is held to the plain version on the
card: ``tests/test_torch_port_cuda.py`` (marked ``cuda``, skipped here) and
``chip_smoke.py``'s "feature sampler kernel" phase.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nerf_fewshot_tpu.training.trainer as jax_trainer_mod
from nerf_fewshot_tpu.data import lego_like_scene as jax_scene
from nerf_fewshot_tpu.data import make_scene_dataset as jax_make_scene
from nerf_fewshot_tpu_torch.data.blender import BlenderDataset
from nerf_fewshot_tpu_torch.render import point_features as tpf
from nerf_fewshot_tpu_torch.training import config as tcfg
from nerf_fewshot_tpu_torch.training import trainer as ttrainer
from nerf_fewshot_tpu_torch.training.trainer import Trainer, _feature_sampler

IMG = 128
RES = 16
MAP = (3, 9, 9, 16)  # three views' 9x9 maps of 16 channels
# an axis-aligned camera (R = I): world-to-camera is exact, so the edge
# points below land where they are meant to, bit for bit
AXIS_T = (1.0, -2.0, -3.0)


def _axis_pose() -> np.ndarray:
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = AXIS_T
    return pose


def _edge_points() -> np.ndarray:
    """Camera points at cz = 2 and -2 (in front of and behind the camera)
    and 0.5 whose image x, y = 16k (focal 64, 128 px) are the 9x9 map's
    integer coordinates k with ``align_corners`` (k = 0 and 8 its edges,
    -1 and 9 off it; with ``align_corners`` False also whole and half
    pixels), plus off-image points; as world points (integers for even k)."""
    ks = np.arange(-1, 10, dtype=np.float64)
    cam = [(k / 2 - 2, j / 2 - 2, 2.0) for k in ks for j in ks[::3]]
    cam += [(k / 2 - 2, 0.25, -2.0) for k in ks]  # behind: the mirrored ray
    cam += [(k / 8 - 0.5, j / 8 - 0.5, 0.5) for k in ks[::2] for j in ks[::4]]
    cam += [(40.0, -3.0, 1.0), (-7.0, 90.0, 2.0), (1.0, 1.0, 1e-3)]  # far off the image
    return (np.asarray(cam) + np.asarray(AXIS_T)).astype(np.float32)


def _point_sets():
    """name -> (c2w of view 1, points, focal): a scene view with points
    around it (the port's DINO test's), and the axis camera's edge points."""
    c2w = np.asarray(jax_make_scene(jax_scene(), 2, img_size=8, gt_samples=8).poses[1])
    rng = np.random.default_rng(23)
    return {"scene": (c2w, rng.uniform(-2.5, 2.5, (300, 3)).astype(np.float32), 110.0),
            "edges": (_axis_pose(), _edge_points(), 64.0)}


POINT_SETS = _point_sets()


def _stacks(c2w: np.ndarray):
    """(V, 4, 4) c2w with ``c2w`` as view 1, the w2c stack each inverted by
    the single-view ``inv_ex`` (as ``Trainer`` does), and seeded maps."""
    poses = np.stack([np.eye(4, dtype=np.float32), c2w, _axis_pose()])
    poses_t = torch.from_numpy(poses)
    w2c = torch.stack([torch.linalg.inv_ex(p)[0] for p in poses_t])
    maps = np.random.default_rng(5).standard_normal(MAP).astype(np.float32)
    return poses_t, w2c, torch.from_numpy(maps)


@pytest.mark.parametrize("fill", ["zeros", "mean"])
@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("projection", ["reference", "script"])
@pytest.mark.parametrize("points", sorted(POINT_SETS))
def test_plain_version_matches_jax(points, projection, align_corners, fill):
    """The wrapper's plain version on the hoisted w2c stack and a view
    index as the graphed step passes it (a one-element int64 tensor)
    against the JAX trainer's ``_feature_sampler`` on that view's map and
    pose: features to atol 1e-5 (the port's DINO test's tolerance); the
    edge set's valid flags equal to z > 0 in float64."""
    c2w, pts, focal = POINT_SETS[points]
    poses, w2c, maps = _stacks(c2w)
    sampler = jax.jit(lambda p, m, c: jax_trainer_mod._feature_sampler(
        m, c, focal, IMG, IMG, align_corners=align_corners, invalid_fill=fill,
        projection=projection)(p))
    want = np.asarray(sampler(jnp.asarray(pts), jnp.asarray(maps[1].numpy()), jnp.asarray(c2w)))
    got, valid = tpf.sample_point_features_valid(
        torch.from_numpy(pts), maps, torch.tensor([1]), poses if projection == "script" else w2c,
        focal, IMG, IMG, align_corners=align_corners, projection=projection, invalid_fill=fill)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    assert np.abs(want).max() > 0.1
    if points == "edges":
        z = pts.astype(np.float64)[:, 2] - AXIS_T[2]
        assert np.array_equal(valid.numpy(), z > 0)
        # every kind of point is there: off the map, behind, on edges
        assert (~valid.numpy()).sum() >= 11 and (np.abs(want).max(axis=1) == 0).any()


def test_hoisted_inverse_is_the_per_call_inverse(scene):
    """``Trainer._w2c_t`` (each view's ``inv_ex`` taken once) bit-equal to
    the inverse the reference projection takes at every call."""
    tr = _trainer(scene, "dino")
    assert tr._w2c_t.shape == (2, 4, 4)
    for v in range(tr.n_views):
        want = torch.linalg.inv_ex(tr._poses_t[v])[0]
        assert np.array_equal(tr._w2c_t[v].numpy().view(np.int32), want.numpy().view(np.int32))


@pytest.mark.parametrize("fill", ["zeros", "mean"])
@pytest.mark.parametrize("projection", ["reference", "script"])
def test_plain_version_is_the_closure_bit_for_bit(projection, fill):
    """On every view, by int and by device-style tensor index: the plain
    version over the stacks bit-equal to ``_feature_sampler`` of the view's
    map and pose (the hoisted inverse moves no bit)."""
    c2w, pts, focal = POINT_SETS["scene"]
    poses, w2c, maps = _stacks(c2w)
    pts_t = torch.from_numpy(pts)
    for v in range(MAP[0]):
        want = _feature_sampler(maps[v], poses[v], focal, IMG, IMG, align_corners=False,
                                invalid_fill=fill, projection=projection)(pts_t)
        for view in (v, torch.tensor([v])):
            got = tpf.sample_point_features(
                pts_t, maps, view, poses if projection == "script" else w2c, focal, IMG, IMG,
                align_corners=False, projection=projection, invalid_fill=fill)
            assert np.array_equal(got.numpy().view(np.int32), want.numpy().view(np.int32))


# ------------------------------------------------------------- the trainer

def _config(kind):
    d = {
        "experiment": {"name": "port-point-features"},
        "data": {"resolution": RES, "num_views": 2},
        "model": {"use_dino": True, "dino_model_type": "single_scale"},
        "nerf_model": {"pos_freq": 12, "dir_freq": 4, "hidden_dim": 128, "num_layers": 3,
                       "sigma_bias": 0.1},
        # phase 0: 8x8 rays per view in batches of 48 (ragged tail of 16);
        # phase 1: 16x16 in batches of 96
        "training": {"epochs": 2, "phases": [
            {"start": 0, "end": 1, "H": 8, "n_samples": 8, "batch_size": 48},
            {"start": 1, "H": RES, "n_samples": 8, "batch_size": 96}]},
        "optimizer": {"lr": 5e-4, "weight_decay": 1e-6},
        "rendering": {"chunk_size": 96},
        "seed": 0,
    }
    if kind == "hierarchical":
        d["rendering"]["n_importance"] = 4
    if kind == "mean":
        d["dino_model"] = {"invalid_fill": "mean"}
    return tcfg.config_from_dict(d)


@pytest.fixture(scope="module")
def scene():
    train = jax_make_scene(jax_scene(), 2, img_size=RES, gt_samples=32)
    test = jax_make_scene(jax_scene(), 1, img_size=RES, gt_samples=32, split="test")
    return train, test


def _port_data(ds):
    return BlenderDataset(np.asarray(ds.images), np.asarray(ds.poses), ds.H, ds.W, ds.focal)


def _trainer(scene, kind):
    train, test = scene
    feats = np.random.default_rng(4).standard_normal((2, 3, 3, 64)).astype(np.float32)
    return Trainer(_config(kind), _port_data(train), _port_data(test), device="cpu",
                   dino_features=feats)


def _bits(t):
    return t.detach().numpy().view(np.int32)


@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("kind", ["dino", "hierarchical", "mean"])
def test_trainer_through_the_wrapper_is_bit_equal(scene, monkeypatch, kind, static):
    """A kernel-path DINO trainer made to sample through the wrapper on the
    CPU (its plain version: the hoisted w2c stack, the view by index)
    against the same trainer through the plain closure, over a phase
    change (``dino_nerf``-like, hierarchical with features sampled at both
    passes, ``invalid_fill: mean``), by the eager steps and by the
    static-buffer body the card captures (its view a device-style tensor):
    per-step losses, parameters and a rendered view bit-equal, the wrapper
    called once per step (twice hierarchical) and once per eval chunk."""
    want_tr = _trainer(scene, kind)
    calls = []

    def counted(*a, **k):
        calls.append(type(a[2]).__name__)
        return tpf.sample_point_features(*a, **k)

    got_tr = _trainer(scene, kind)
    monkeypatch.setattr(got_tr, "_sampler_kernel", got_tr._use_fused)
    monkeypatch.setattr(ttrainer, "sample_point_features", counted)
    steps = 0
    for epoch in (0, 1):
        run = (lambda tr: tr._static_epoch_steps(epoch)) if static else \
            (lambda tr: torch.as_tensor(tr.epoch_steps(epoch)))
        want, got = run(want_tr), run(got_tr)
        assert np.array_equal(_bits(got), _bits(want)), epoch
        steps += got.shape[0]
    assert got_tr.kernel_path == "kernel"
    assert len(calls) == steps * (2 if kind == "hierarchical" else 1)
    assert set(calls) == {"Tensor" if static else "int"}
    for (k, p), (_, q) in zip(got_tr.model.named_parameters(), want_tr.model.named_parameters()):
        assert np.array_equal(_bits(p), _bits(q)), k
    calls.clear()
    pose = [np.asarray(scene[1].poses[0])]
    for a, b in zip(got_tr.render_views(pose), want_tr.render_views(pose)):
        assert np.array_equal(a.view(np.int32), b.view(np.int32))
    n_chunks = -(-RES * RES // 96)
    assert len(calls) == n_chunks * (2 if kind == "hierarchical" else 1)


def test_sampler_choice(scene):
    """The kernel path samples through the kernel only on a card: on the
    CPU, and on the plain path anywhere, ``_feature_sampler`` stays."""
    tr = _trainer(scene, "dino")
    assert tr._use_fused() and not tr._sampler_kernel()
    plain = Trainer(tcfg.config_from_dict({**_config("dino").raw,
                                           "rendering": {"chunk_size": 96, "backend": "xla"}}),
                    _port_data(scene[0]), device="cpu", dino_features=tr.dino_features.numpy())
    assert not plain._sampler_kernel() and plain.kernel_path == "plain"


# ------------------------------------------------------------- refusals

def _refusal_args():
    pts = torch.zeros((8, 3))
    maps = torch.zeros(MAP)
    poses = torch.eye(4).expand(MAP[0], 4, 4).contiguous()
    return dict(pts=pts, maps=maps, view=0, pose_mats=poses)


REFUSALS = {
    "maps requires grad": dict(maps=torch.zeros(MAP, requires_grad=True)),
    "points require grad": dict(pts=torch.zeros((8, 3), requires_grad=True)),
    "float64 points": dict(pts=torch.zeros((8, 3), dtype=torch.float64)),
    "float16 maps": dict(maps=torch.zeros(MAP, dtype=torch.float16)),
    "points (N, 2)": dict(pts=torch.zeros((8, 2))),
    "points (N, 3, 1)": dict(pts=torch.zeros((8, 3, 1))),
    "non-contiguous points": dict(pts=torch.zeros((3, 8)).T),
    "non-contiguous maps": dict(maps=torch.zeros(MAP).transpose(1, 2)),
    "maps of one view": dict(maps=torch.zeros(MAP[1:])),
    "poses (V, 3, 4)": dict(pose_mats=torch.zeros((MAP[0], 3, 4))),
    "poses of another view count": dict(pose_mats=torch.zeros((2, 4, 4))),
    "view out of range": dict(view=MAP[0]),
    "negative view": dict(view=-1),
    "view tensor out of range": dict(view=torch.tensor([MAP[0]])),
    "int32 view tensor": dict(view=torch.tensor([0], dtype=torch.int32)),
    "two views": dict(view=torch.tensor([0, 1])),
    "float view": dict(view=0.0),
    "unknown projection": dict(projection="pinhole"),
    "unknown fill": dict(invalid_fill="nearest"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_wrapper_refuses(case):
    """Each refusal raises on the CPU as on a card (a device view index out
    of range is the kernel's to catch there); the unchanged call runs."""
    opts = dict(align_corners=False, projection="reference", invalid_fill="zeros")
    args = _refusal_args()
    tpf.sample_point_features(args["pts"], args["maps"], args["view"], args["pose_mats"], 64.0,
                              IMG, IMG, **opts)
    over = dict(REFUSALS[case])
    args.update({k: over.pop(k) for k in list(over) if k in args})
    opts.update(over)
    with pytest.raises(ValueError):
        tpf.sample_point_features(args["pts"], args["maps"], args["view"], args["pose_mats"],
                                  64.0, IMG, IMG, **opts)
