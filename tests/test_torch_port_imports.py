"""The port must start on a machine that has torch, numpy and the standard
library and none of jax, flax, optax, yaml or PIL; and with no card it must
refuse a CUDA request instead of falling back to the CPU.
"""

import ast
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "nerf_fewshot_tpu_torch")
ALLOWED_TOP = {"torch", "numpy", "nerf_fewshot_tpu_torch", "__future__"}
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "yaml", "PIL", "nerf_fewshot_tpu"}
# the only lazy imports of a forbidden module: (file, function, module)
LAZY_ALLOWED = {
    ("data/blender.py", "load_blender", "PIL"),
}


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(PKG):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imports(tree):
    """Yield (top-level module, enclosing function or None) per import."""

    def walk(node, func):
        for child in ast.iter_child_nodes(node):
            f = child.name if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)) else func
            if isinstance(child, ast.Import):
                for a in child.names:
                    yield a.name.split(".")[0], func
            elif isinstance(child, ast.ImportFrom):
                if child.level:
                    yield "nerf_fewshot_tpu_torch", func
                else:
                    yield child.module.split(".")[0], func
            yield from walk(child, f)

    yield from walk(tree, None)


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: os.path.relpath(p, ROOT))
def test_port_imports_only_torch_numpy_stdlib(path):
    rel = os.path.relpath(path, PKG).replace(os.sep, "/")
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    stdlib = sys.stdlib_module_names
    for mod, func in _imports(tree):
        if mod in FORBIDDEN:
            assert (rel, func, mod) in LAZY_ALLOWED, f"{rel}: imports {mod} in {func or 'module scope'}"
        elif func is None:
            assert mod in ALLOWED_TOP or mod in stdlib, f"{rel}: module-level import of {mod}"


def test_every_port_module_imports_without_forbidden_modules():
    """Import the whole package and chip_smoke in a fresh interpreter where
    the forbidden modules cannot be found (any a site hook loaded first are
    dropped from sys.modules)."""
    import subprocess

    code = (
        "import sys, importlib, pkgutil\n"
        f"blocked = {sorted(FORBIDDEN)!r}\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in blocked: raise ImportError('blocked ' + name)\n"
        "for k in [k for k in sys.modules if k.split('.')[0] in blocked]: del sys.modules[k]\n"
        "sys.meta_path.insert(0, Block())\n"
        "import nerf_fewshot_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip().endswith("ok"), proc.stderr


def _tiny_kernel_args(device):
    from nerf_fewshot_tpu_torch.render import kernels as tk

    R, S = 2, 4
    state = {"trunk.0.weight": torch.zeros(128, 90), "trunk.0.bias": torch.zeros(128),
             "trunk.1.weight": torch.zeros(128, 128), "trunk.1.bias": torch.zeros(128),
             "rgb_head.weight": torch.zeros(3, 128), "rgb_head.bias": torch.zeros(3),
             "sigma_head.weight": torch.zeros(1, 128), "sigma_head.bias": torch.zeros(1)}
    perm, e2, c, _ = tk.pe_layout(10, 4, True, 0)
    packed = tuple(t.to(device) for t in tk.pack_params(state, 2, 128, row_perm=perm))
    f = lambda *shape: torch.zeros(*shape, device=device)
    return (f(R * S, 6), None, f(R, S), f(R, 1), torch.as_tensor(e2, device=device),
            torch.as_tensor(c, device=device), packed)


def test_kernel_wrapper_refuses_non_cpu_tensors_without_a_kernel():
    """A tensor that is not on the CPU never reaches the plain version."""
    from nerf_fewshot_tpu_torch.render import kernels as tk

    before = tk.fused_render_fwd_pe.launches
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tk.fused_render_fwd_pe(*_tiny_kernel_args("meta"))
    assert tk.fused_render_fwd_pe.launches == before
    # the CPU path runs the plain version and launches nothing
    tk.fused_render_fwd_pe(*_tiny_kernel_args("cpu"))
    assert tk.fused_render_fwd_pe.launches == before


def test_cuda_requests_raise_without_a_card(monkeypatch):
    from nerf_fewshot_tpu_torch.data.synthetic import lego_like_scene, make_scene_dataset
    from nerf_fewshot_tpu_torch.device import resolve_device
    from nerf_fewshot_tpu_torch.render.fused import fused_render_rays
    from nerf_fewshot_tpu_torch.render.pipeline import RenderSettings
    from nerf_fewshot_tpu_torch.training.config import config_from_dict
    from nerf_fewshot_tpu_torch.training.trainer import Trainer
    from nerf_fewshot_tpu_torch.data.blender import BlenderDataset

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert resolve_device("cpu") == torch.device("cpu")
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device(device)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_scene_dataset(lego_like_scene(), 1, img_size=4, gt_samples=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fused_render_rays({}, torch.zeros(4, 3), torch.ones(4, 3), RenderSettings(n_samples=4),
                          pos_freq=10, dir_freq=4, num_layers=2, hidden_dim=128,
                          forward_only=True, device="cuda")
    cfg = config_from_dict({"nerf_model": {"hidden_dim": 128, "num_layers": 2}})
    data = BlenderDataset(np.zeros((1, 4, 4, 3), np.float32),
                          np.eye(4, dtype=np.float32)[None], 4, 4, 5.0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg, data)


def test_chip_smoke_fails_without_a_card_or_outside_the_repo(tmp_path):
    """No card: exit code 2 and no result line. Alone in a directory: the
    import of the port fails, non-zero and no result line either."""
    import shutil
    import subprocess

    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    runs = [(ROOT, os.path.join(ROOT, "chip_smoke.py"))]
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    runs.append((str(tmp_path), str(tmp_path / "chip_smoke.py")))
    for cwd, script in runs:
        proc = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode != 0, (cwd, proc.stdout, proc.stderr)
        assert '"ok"' not in proc.stdout, proc.stdout
