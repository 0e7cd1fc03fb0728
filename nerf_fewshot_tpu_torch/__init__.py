"""PyTorch + CUDA port of ``nerf_fewshot_tpu`` for NVIDIA Hopper (sm_90a).

The layers mirror the JAX package (``ops/ models/ render/ data/
training/ parallel/ utils/``); each module is a counterpart of the JAX file of the same
name and is held against it by ``tests/test_torch_port_*.py``. The port
imports torch, numpy and the standard library only.

Entry points (``python -m nerf_fewshot_tpu_torch.cli``,
``training.trainer.Trainer``, ``render.fused_render_rays``,
``data.synthetic.make_scene_dataset``,
``models.dino.build_feature_extractor``) run on ``cuda`` unless the caller
passes ``device="cpu"``; with no card and no explicit CPU request they
raise. On CUDA tensors the render path launches the hand-written kernel in
``csrc/fwd_pe.cu`` and each training step the one in ``csrc/train_pe.cu``;
on CPU tensors each runs its kernel's plain PyTorch version.
"""
