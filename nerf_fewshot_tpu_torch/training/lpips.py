"""LPIPS(VGG16) in PyTorch (counterpart of
``nerf_fewshot_tpu/training/lpips_jax.py``).

The ``lpips.LPIPS(net='vgg')`` forward: the ScalingLayer ``(x - shift) /
scale``; the VGG16 feature trunk (13 3x3 convs with ReLU, 2x2 max-pools),
tapped after relu1_2 / relu2_2 / relu3_3 / relu4_3 / relu5_3; each tap
unit-normalized over channels (eps 1e-10); the squared difference through a
1x1 no-bias head per tap; the spatial mean; the sum over taps. An image
needs at least 16x16 pixels to reach relu5_3.

Without weights on disk the trunk is the JAX package's seeded-random VGG
(``init_params``: the same ``np.random.default_rng`` draws in the same
order, so the port's parameters are bit-identical to the JAX ones) with
uniform ``1/C`` heads: a fixed, valid perceptual distance whose absolute
scale differs from the published pretrained-VGG numbers. With a torchvision
``vgg16`` state dict (and optionally the lpips heads) on disk
(``find_weight_files``), ``load_torch_weights`` imports them and
``pretrained`` says so.

Precision: on a card ``F.conv2d`` goes to cuDNN, which takes TF32 for fp32
convolutions while ``torch.backends.cudnn.allow_tf32`` is set (PyTorch's
default), about 1e-3 relative off. ``LPIPS`` runs the trunk with that flag
cleared for the call and restored after it; the heads are a multiply and a
channel sum, with no matrix product that TF32 could take.
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from nerf_fewshot_tpu_torch.device import DeviceLike, resolve_device

# torchvision vgg16 `features`: the channel plan, 'M' = 2x2/2 max-pool
VGG16_PLAN: Tuple = (
    64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
    512, 512, 512, "M", 512, 512, 512,
)
# taps after relu1_2 / 2_2 / 3_3 / 4_3 / 5_3 (1-based count of convs done)
TAP_AFTER_CONV = (2, 4, 7, 10, 13)
TAP_CHANNELS = (64, 128, 256, 512, 512)

# lpips ScalingLayer constants (lpips/lpips.py)
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)

Params = Dict[str, List[Dict[str, torch.Tensor]]]


def init_params(seed: int = 0, device: DeviceLike = "cpu") -> Params:
    """The seeded-random parameters: 13 convs ``{"weight" (O, I, 3, 3),
    "bias"}`` drawn as the JAX package draws its HWIO kernels
    (``standard_normal((3, 3, c_in, c_out)) * sqrt(2 / fan_in)``), then
    transposed, and 5 heads ``{"weight" (C,)}`` of ``1/C``."""
    dev = torch.device(device)
    rng = np.random.default_rng(seed)
    convs, c_in = [], 3
    for spec in VGG16_PLAN:
        if spec == "M":
            continue
        w = rng.standard_normal((3, 3, c_in, spec)).astype(np.float32)
        w *= np.sqrt(2.0 / (3 * 3 * c_in))
        convs.append({"weight": torch.from_numpy(w.transpose(3, 2, 0, 1).copy()).to(dev),
                      "bias": torch.zeros(spec, device=dev)})
        c_in = spec
    lins = [{"weight": torch.full((c,), 1.0 / c, device=dev)} for c in TAP_CHANNELS]
    return {"convs": convs, "lins": lins}


def _vgg_taps(params: Params, x: torch.Tensor) -> List[torch.Tensor]:
    """The VGG16 trunk on (N, 3, H, W): the five tap activations (N, C, h, w)."""
    h, taps, conv_i = x, [], 0
    for spec in VGG16_PLAN:
        if spec == "M":
            h = F.max_pool2d(h, kernel_size=2, stride=2)
            continue
        p = params["convs"][conv_i]
        h = torch.relu(F.conv2d(h, p["weight"], p["bias"], padding=1))
        conv_i += 1
        if conv_i in TAP_AFTER_CONV:
            taps.append(h)
    return taps


def _unit_normalize(f: torch.Tensor) -> torch.Tensor:
    """lpips ``normalize_tensor`` of a (C, h, w) tap: divide by the
    channel-wise L2 norm."""
    return f / (torch.sqrt(torch.sum(f * f, dim=0, keepdim=True)) + 1e-10)


def lpips_distance(params: Params, img0: torch.Tensor, img1: torch.Tensor) -> torch.Tensor:
    """LPIPS between two (H, W, 3) images in [-1, 1], a scalar; the two go
    through the trunk as one batch. Runs under the caller's TF32 settings
    (``LPIPS`` clears them)."""
    shift = torch.as_tensor(_SHIFT, device=img0.device)
    scale = torch.as_tensor(_SCALE, device=img0.device)
    x = (torch.stack([img0, img1]) - shift) / scale
    total = torch.zeros((), device=img0.device)
    for t, lin in zip(_vgg_taps(params, x.permute(0, 3, 1, 2)), params["lins"]):
        d = (_unit_normalize(t[0]) - _unit_normalize(t[1])) ** 2  # (C, h, w)
        total = total + torch.mean(torch.sum(d * lin["weight"][:, None, None], dim=0))
    return total


def load_torch_weights(
    params: Params,
    vgg_state_dict: Optional[Dict] = None,
    lpips_state_dict: Optional[Dict] = None,
) -> Params:
    """Merge pretrained weights into a copy of ``params``.

    ``vgg_state_dict``: torchvision ``vgg16().state_dict()`` (keys
    ``features.{i}.weight/bias``, OIHW). ``lpips_state_dict``: the lpips
    package's vgg heads (keys ``lin{k}.model.1.weight`` or
    ``lins.{k}.model.1.weight``, shape (1, C, 1, 1)). Either may be None; a
    conv is taken only when its shape matches."""
    out = {"convs": [dict(c) for c in params["convs"]],
           "lins": [dict(c) for c in params["lins"]]}
    as_f32 = lambda v, like: torch.as_tensor(np.asarray(v, np.float32), device=like.device)
    if vgg_state_dict is not None:
        seq_idx, conv_i = 0, 0
        for spec in VGG16_PLAN:
            if spec == "M":
                seq_idx += 1  # the pool layer
                continue
            wk, bk = f"features.{seq_idx}.weight", f"features.{seq_idx}.bias"
            conv = out["convs"][conv_i]
            if wk in vgg_state_dict and tuple(np.shape(vgg_state_dict[wk])) == tuple(
                    conv["weight"].shape):
                conv["weight"] = as_f32(vgg_state_dict[wk], conv["weight"])
                conv["bias"] = as_f32(vgg_state_dict[bk], conv["bias"])
            seq_idx += 2  # conv + relu
            conv_i += 1
    if lpips_state_dict is not None:
        for k, lin in enumerate(out["lins"]):
            key = f"lin{k}.model.1.weight"
            if key not in lpips_state_dict:
                key = f"lins.{k}.model.1.weight"
            if key in lpips_state_dict:
                lin["weight"] = as_f32(np.asarray(lpips_state_dict[key])[0, :, 0, 0],
                                       lin["weight"])
    return out


def find_weight_files() -> Tuple[Optional[str], Optional[str]]:
    """``(vgg16_path, lpips_head_path)`` of torch checkpoints on disk, if
    any: ``$NERF_LPIPS_VGG`` / ``$NERF_LPIPS_HEADS`` first, then the first
    ``vgg16*.pth`` in ``$TORCH_HOME/hub/checkpoints`` (default
    ``~/.cache/torch``)."""
    vgg = os.environ.get("NERF_LPIPS_VGG")
    heads = os.environ.get("NERF_LPIPS_HEADS")
    hub = os.path.join(os.environ.get("TORCH_HOME", os.path.expanduser("~/.cache/torch")),
                       "hub", "checkpoints")
    if vgg is None and os.path.isdir(hub):
        for name in sorted(os.listdir(hub)):
            if name.startswith("vgg16") and name.endswith(".pth"):
                vgg = os.path.join(hub, name)
                break
    return vgg, heads


@contextlib.contextmanager
def exact_fp32_convs():
    """Clear ``torch.backends.cudnn.allow_tf32`` for the block and restore
    it after. (``torch.backends.cudnn.flags`` would also reset ``enabled``
    to its own default, False, and send the convs to another backend.)"""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


class LPIPS:
    """Parameters on ``device`` (``cuda`` unless the caller passes
    ``"cpu"``): pretrained when a VGG16 state dict on disk loads, else the
    seeded-random ones, built at the first call. Calls take images in
    [0, 1] and scale them to [-1, 1], as the reference does."""

    def __init__(self, seed: int = 0, device: DeviceLike = None):
        self.seed = seed
        self.device = resolve_device(device)
        self.pretrained = False
        self._params: Optional[Params] = None
        vgg_path, heads_path = find_weight_files()
        if vgg_path is not None:
            try:
                sd = torch.load(vgg_path, map_location="cpu", weights_only=True)
                heads = (torch.load(heads_path, map_location="cpu", weights_only=True)
                         if heads_path is not None else None)
                self._params = load_torch_weights(init_params(seed, self.device), sd, heads)
                self.pretrained = True
            except Exception as e:  # a weight file that does not load: the random VGG
                print(f"[lpips] {vgg_path} did not load ({type(e).__name__}: {e}); "
                      f"using the seeded-random VGG")

    @property
    def params(self) -> Params:
        if self._params is None:
            self._params = init_params(self.seed, self.device)
        return self._params

    @torch.no_grad()
    def __call__(self, pred01, target01) -> float:
        """LPIPS between two (H, W, 3) images in [0, 1]."""
        p, t = (torch.as_tensor(x, dtype=torch.float32, device=self.device) * 2.0 - 1.0
                for x in (pred01, target01))
        with exact_fp32_convs():
            return float(lpips_distance(self.params, p, t))
