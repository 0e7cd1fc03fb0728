"""LPIPS(VGG16) and the plots of the port (``training/lpips.py``,
``training/metrics.py:LPIPSMetric``, ``utils/plots.py``) against the JAX
package's ``training/lpips_jax.py``, ``LPIPSMetric`` and ``utils/plots.py``
on the same numpy inputs.

Tolerances: the seeded-random parameters bit-equal; distances within rel
1e-4 (fp32 convolutions summed in other orders), 0 exactly for identical
images; the colormap bit-equal; the PNGs pixel for pixel (decoded with
Pillow on the CPU).
"""

import numpy as np
import pytest
import torch
from PIL import Image

from nerf_fewshot_tpu.training import lpips_jax as jl
from nerf_fewshot_tpu.training import metrics as jmetrics
from nerf_fewshot_tpu.utils import plots as jplots
from nerf_fewshot_tpu_torch.training import lpips as tl
from nerf_fewshot_tpu_torch.training import metrics as tmetrics
from nerf_fewshot_tpu_torch.utils import plots as tplots


@pytest.fixture(scope="module")
def params():
    return jl.init_params(0), tl.init_params(0)


def _pairs(seed, size, n=3):
    rng = np.random.default_rng(seed)
    return [tuple(rng.uniform(-1, 1, (size, size, 3)).astype(np.float32) for _ in range(2))
            for _ in range(n)]


def test_constants_and_seeded_params_are_the_jax_ones(params):
    jp, tp = params
    assert tl.VGG16_PLAN == jl.VGG16_PLAN and tl.TAP_AFTER_CONV == jl.TAP_AFTER_CONV
    assert tl.TAP_CHANNELS == jl.TAP_CHANNELS
    np.testing.assert_array_equal(tl._SHIFT, jl._SHIFT)
    np.testing.assert_array_equal(tl._SCALE, jl._SCALE)
    assert len(tp["convs"]) == len(jp["convs"]) == 13
    for j, t in zip(jp["convs"], tp["convs"]):
        np.testing.assert_array_equal(t["weight"].numpy(),
                                      np.asarray(j["kernel"]).transpose(3, 2, 0, 1))
        np.testing.assert_array_equal(t["bias"].numpy(), np.asarray(j["bias"]))
    for j, t in zip(jp["lins"], tp["lins"]):
        np.testing.assert_array_equal(t["weight"].numpy(), np.asarray(j["kernel"])[:, 0])
    other = tl.init_params(1)
    assert not torch.equal(other["convs"][0]["weight"], tp["convs"][0]["weight"])


@pytest.mark.parametrize("size", [16, 32])
def test_distance_matches_jax(params, size):
    """Random pairs: rel 1e-4 each; identical images: 0 exactly."""
    jp, tp = params
    pairs = _pairs(size, size)
    want = np.array([float(jl._jit_distance(jp, a, b)) for a, b in pairs])
    got = np.array([float(tl.lpips_distance(tp, torch.from_numpy(a), torch.from_numpy(b)))
                    for a, b in pairs])
    np.testing.assert_allclose(got, want, rtol=1e-4)
    a = torch.from_numpy(pairs[0][0])
    assert float(tl.lpips_distance(tp, a, a)) == 0.0
    assert float(jl._jit_distance(jp, pairs[0][0], pairs[0][0])) == 0.0


def _state_dicts(seed=3):
    """A torchvision-layout vgg16 ``features`` state dict (with the
    classifier's keys, which are ignored) and lpips heads, half of them
    under each key spelling."""
    rng = np.random.default_rng(seed)
    vgg, seq, c_in = {}, 0, 3
    for spec in tl.VGG16_PLAN:
        if spec == "M":
            seq += 1
            continue
        vgg[f"features.{seq}.weight"] = torch.from_numpy(
            (rng.standard_normal((spec, c_in, 3, 3)) * 0.05).astype(np.float32))
        vgg[f"features.{seq}.bias"] = torch.from_numpy(
            rng.uniform(-0.1, 0.1, spec).astype(np.float32))
        seq += 2
        c_in = spec
    vgg["classifier.0.weight"] = torch.zeros(4, 4)
    heads = {(f"lin{k}" if k % 2 else f"lins.{k}") + ".model.1.weight": torch.from_numpy(
        rng.uniform(0, 0.1, (1, c, 1, 1)).astype(np.float32))
        for k, c in enumerate(tl.TAP_CHANNELS)}
    return vgg, heads


def test_load_torch_weights_matches_jax(params):
    jp, tp = params
    vgg, heads = _state_dicts()
    jw = jl.load_torch_weights(jp, {k: v.numpy() for k, v in vgg.items()},
                               {k: v.numpy() for k, v in heads.items()})
    tw = tl.load_torch_weights(tp, vgg, heads)
    for j, t in zip(jw["convs"], tw["convs"]):
        np.testing.assert_array_equal(t["weight"].numpy(),
                                      np.asarray(j["kernel"]).transpose(3, 2, 0, 1))
        np.testing.assert_array_equal(t["bias"].numpy(), np.asarray(j["bias"]))
    for j, t in zip(jw["lins"], tw["lins"]):
        np.testing.assert_array_equal(t["weight"].numpy(), np.asarray(j["kernel"])[:, 0])
    assert torch.equal(tp["convs"][0]["weight"], tl.init_params(0)["convs"][0]["weight"])
    (a, b), = _pairs(7, 32, n=1)
    np.testing.assert_allclose(float(tl.lpips_distance(tw, torch.from_numpy(a),
                                                       torch.from_numpy(b))),
                               float(jl._jit_distance(jw, a, b)), rtol=1e-4)


def test_weight_discovery_and_the_metric_match_jax(tmp_path, monkeypatch):
    """Nothing on disk: both metrics run the seeded-random VGG, tagged
    ``*-random-vgg``, same values on [0, 1] inputs. With ``$NERF_LPIPS_VGG``
    / ``$NERF_LPIPS_HEADS`` pointing at state dicts the test writes, both
    find them, load them and say ``pretrained``."""
    monkeypatch.setenv("TORCH_HOME", str(tmp_path / "hub_home"))
    monkeypatch.delenv("NERF_LPIPS_VGG", raising=False)
    monkeypatch.delenv("NERF_LPIPS_HEADS", raising=False)
    assert tl.find_weight_files() == jl.find_weight_files() == (None, None)
    rng = np.random.default_rng(5)
    a, b = (rng.uniform(0, 1, (32, 32, 3)).astype(np.float32) for _ in range(2))
    jm, tm = jmetrics.LPIPSMetric(), tmetrics.LPIPSMetric("cpu")
    assert (jm.pretrained, jm.backend) == (False, "jax-random-vgg")
    assert (tm.pretrained, tm.backend) == (False, "torch-random-vgg")
    np.testing.assert_allclose(tm(a, b), jm(a, b), rtol=1e-4)
    assert tm(torch.from_numpy(a), torch.from_numpy(b)) == tm(a, b)

    vgg, heads = _state_dicts()
    torch.save(vgg, tmp_path / "vgg.pth")
    torch.save(heads, tmp_path / "heads.pth")
    hub = tmp_path / "hub_home" / "hub" / "checkpoints"
    hub.mkdir(parents=True)
    torch.save(vgg, hub / "vgg16-397923af.pth")
    assert tl.find_weight_files() == jl.find_weight_files() == (str(hub / "vgg16-397923af.pth"),
                                                                None)
    monkeypatch.setenv("NERF_LPIPS_VGG", str(tmp_path / "vgg.pth"))
    monkeypatch.setenv("NERF_LPIPS_HEADS", str(tmp_path / "heads.pth"))
    assert tl.find_weight_files() == jl.find_weight_files() == (str(tmp_path / "vgg.pth"),
                                                                str(tmp_path / "heads.pth"))
    jm, tm = jmetrics.LPIPSMetric(), tmetrics.LPIPSMetric("cpu")
    assert (jm.pretrained, tm.pretrained) == (True, True)
    assert tm.backend == "torch-pretrained-vgg"
    np.testing.assert_allclose(tm(a, b), jm(a, b), rtol=1e-4)


def test_a_cuda_request_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmetrics.LPIPSMetric()


def test_exact_fp32_convs_restores_the_flag():
    prev = torch.backends.cudnn.allow_tf32
    for start in (True, False):
        torch.backends.cudnn.allow_tf32 = start
        try:
            with tl.exact_fp32_convs():
                assert torch.backends.cudnn.allow_tf32 is False
            assert torch.backends.cudnn.allow_tf32 is start
        finally:
            torch.backends.cudnn.allow_tf32 = prev


@pytest.mark.parametrize("cmap", ["viridis", "plasma"])
def test_colormap_is_bit_equal(cmap):
    rng = np.random.default_rng(2)
    v = rng.standard_normal((7, 9)).astype(np.float32)
    np.testing.assert_array_equal(tplots.apply_colormap(v, cmap),
                                  jplots.apply_colormap(v, cmap))
    np.testing.assert_array_equal(tplots.apply_colormap(v, cmap, vmin=-0.5, vmax=0.5),
                                  jplots.apply_colormap(v, cmap, vmin=-0.5, vmax=0.5))
    flat = np.full((3, 3), 2.0, np.float32)  # hi == lo
    np.testing.assert_array_equal(tplots.apply_colormap(flat, cmap),
                                  jplots.apply_colormap(flat, cmap))


@pytest.mark.parametrize("plot", ["heatmap", "colormapped", "histogram"])
def test_plot_pngs_decode_to_the_jax_pixels(tmp_path, plot):
    rng = np.random.default_rng(9)
    data = {"heatmap": rng.uniform(0.2, 1.0, (5, 5)),
            "colormapped": rng.uniform(2.0, 6.0, (20, 24)).astype(np.float32),
            "histogram": rng.normal(4.0, 0.5, 1000)}[plot]
    fn = {"heatmap": "save_heatmap", "colormapped": "save_colormapped",
          "histogram": "save_histogram"}[plot]
    getattr(jplots, fn)(str(tmp_path / "jax.png"), data)
    getattr(tplots, fn)(str(tmp_path / "port.png"), data)
    want = np.asarray(Image.open(tmp_path / "jax.png").convert("RGB"))
    got = np.asarray(Image.open(tmp_path / "port.png"))
    assert got.shape == want.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
