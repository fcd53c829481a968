"""dasac_tpu_torch — the PyTorch/CUDA counterpart of ``dasac_tpu``, for NVIDIA
Hopper GPUs.

The layout mirrors ``dasac_tpu`` so each module's counterpart is found by
name; this package imports nothing of it (the JAX package is the reference
the tests hold this one against).

  core/   device selection, train state, config (YAML subset), CLI flags
  aug/    device-side augmentation (affine warps + photometric ops)
  data/   PNG codec, split lists, samplers, memmap packs, prefetch loaders,
          synthetic roots
  nn/     models (DeepLabv2 ResNet-101, TinySeg), frozen/batch-stat BN,
          weight carry-across from the flax variables
  ops/    hand-written GPU kernels (fused per-pixel CE pair, Triton)
  sac/    the adaptation algorithm (EMA teacher, running conf,
          pseudo-labels, focal CE, multi-view refinement)
  train/  optimizer groups, the SAC and ABN train steps, the eval steps,
          metrics, checkpoints (the reference's .pth container), the
          Trainer and its CLI (python -m dasac_tpu_torch.train.cli)
  infer/  multi-scale (+flip) inference program
  utils/  event/image writers, visual panels, timer

Public tensors are channels-last (NHWC), as in ``dasac_tpu``.
"""

__version__ = "0.1.0"
