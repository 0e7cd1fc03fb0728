"""Export the JAX package's ``multi_scale`` feature maps of the synthetic
training views to an ``.npz``, for training the PyTorch port on them.

    python tools/export_multiscale_maps.py [--config experiments/multiscale.yaml] \
        [--out tools/multiscale_jax_maps.npz]

Runs on the CPU. Builds the config's extractor as the JAX command line does
(``nerf_fewshot_tpu.cli._precompute_features``: ``build_feature_extractor``
at the config's resolution, its seed-0 random init, no pretrained weights
on disk) over the ``num_views`` training views of the procedural lego-like
scene, white-composited, and writes ``maps`` (V, Hp, Wp, Fd) float32 with
the config's path and the maps' statistics (mean, std, the share of exact
zeros, and the std over the patch grid per view and channel, averaged).
It prints the same statistics of the PyTorch port's own maps of the same
views (``nerf_fewshot_tpu_torch.cli._precompute_features`` on the CPU, the
port's seed-0 init) beside them. ``python -m nerf_fewshot_tpu_torch.cli
train --config experiments/multiscale.yaml --synthetic --features <out>``
then trains the port on these maps instead of its own extractor's.
"""

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default=os.path.join(ROOT, "experiments", "multiscale.yaml"))
    ap.add_argument("--out", default=os.path.join(ROOT, "tools", "multiscale_jax_maps.npz"))
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from nerf_fewshot_tpu.cli import _load_datasets, _precompute_features
    from nerf_fewshot_tpu.training.config import load_config

    def stats(m):
        return dict(mean=float(m.mean()), std=float(m.std()), zero_share=float((m == 0).mean()),
                    grid_std=float(m.std(axis=(1, 2)).mean()))

    cfg = load_config(args.config)
    train, _ = _load_datasets(cfg, synthetic=True)
    maps = np.asarray(_precompute_features(cfg, train), np.float32)
    np.savez_compressed(args.out, maps=maps, config=os.path.relpath(args.config, ROOT),
                        **stats(maps))
    print(f"{args.out}: maps {maps.shape}, {os.path.getsize(args.out)} bytes, {stats(maps)}")

    import torch

    from nerf_fewshot_tpu_torch import cli as port_cli
    from nerf_fewshot_tpu_torch.training.config import load_config as port_load_config

    port_cfg = port_load_config(args.config)
    port_train, _ = port_cli._load_datasets(port_cfg, True, torch.device("cpu"))
    port = port_cli._precompute_features(port_cfg, port_train, torch.device("cpu"))
    print(f"the port's own maps {port.shape}: {stats(port)}")


if __name__ == "__main__":
    main()
