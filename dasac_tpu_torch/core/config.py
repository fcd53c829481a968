"""Global configuration (a copy of ``dasac_tpu/core/config.py``).

Same YAML schema, keys and defaults as ``dasac_tpu`` and the reference
config system (reference core/config.py:45-176), so the reference's and
this repo's ``configs/*.yaml`` load unmodified.  The YAML is read by
:mod:`dasac_tpu_torch.core.yaml_subset`, which types values exactly as
``yaml.safe_load`` does.

The ``TPU`` section is kept whole so every config loads, but:

  * ``TPU.COMPILE_CACHE`` (XLA's persistent compile cache),
    ``TPU.RESIZE_METHOD`` (XLA's resize formulation) and ``TPU.CKPT_LOSS``
    (XLA loss rematerialization) are accepted and not read;
  * ``TPU.MESH_DEVICES`` is the number of data-parallel processes, one per
    device, that the train CLI spawns (0 = as many visible GPUs as divide
    both batch dimensions); ``TPU.PARTITION`` "gspmd", ``TPU.MESH_SP`` > 1
    and ``TPU.REMAT`` other than "none" make the trainer raise
    ``NotImplementedError`` (height sharding and remat are still to be
    ported);
  * ``TPU.CE_IMPL`` "pallas" selects the CUDA CE kernels, "xla" the plain
    log-softmax; ``TPU.COMPUTE_DTYPE``, ``REFINE_DTYPE``, ``REFINE_RES``,
    ``LOSS_DTYPE``, ``LOADER_THREADS``, ``PREFETCH``, ``PACKED_DIR`` and
    ``NATIVE_LOADER`` mean what they mean in ``dasac_tpu``, except that
    the ``native/`` decoder, when on and not buildable, raises instead of
    giving way to a Python decode.

Usage:
    from dasac_tpu_torch.core.config import cfg, cfg_from_file, cfg_from_list
"""

import copy
from ast import literal_eval

from dasac_tpu_torch.core import yaml_subset
from dasac_tpu_torch.utils.collections import AttrDict

__C = AttrDict()
cfg = __C

# ---------------------------------------------------------------------------
# Training options (reference: core/config.py:45-63)
# ---------------------------------------------------------------------------
__C.TRAIN = AttrDict()
__C.TRAIN.BATCH_SIZE = 16
__C.TRAIN.NUM_EPOCHS = 200
__C.TRAIN.TASK = "train_game_9K"        # source data split
__C.TRAIN.TARGET = "train_cityscapes"   # target data split
__C.TRAIN.TARGET_ONLY = False
# target batch = NUM_GROUPS unique images x GROUP_SIZE augmented views each
__C.TRAIN.NUM_GROUPS = 4
__C.TRAIN.GROUP_SIZE = 2

# ---------------------------------------------------------------------------
# Validation options (reference: core/config.py:67-68)
# ---------------------------------------------------------------------------
__C.VAL = AttrDict()
# class indices dropped from reported mIoU (SYNTHIA 16-class protocol: [9,14,16])
__C.VAL.IGNORE_CLASS = []

# ---------------------------------------------------------------------------
# Dataset + augmentation options (reference: core/config.py:73-125)
# ---------------------------------------------------------------------------
__C.DATASET = AttrDict()
__C.DATASET.CROP_SIZE = [512, 512]      # (H, W)
__C.DATASET.VAL_CROP = True             # center-crop for validation (else rescale)
__C.DATASET.RND_CROP = True
__C.DATASET.RND_BLUR = True
__C.DATASET.RND_GREYSCALE = 0.0
__C.DATASET.RND_HFLIP = True
__C.DATASET.RND_JITTER = 0.0
__C.DATASET.RND_ZOOM = [0.5, 1.2]       # per-view zoom range (target consistency)
__C.DATASET.GUIDED_HFLIP = False        # per-view flip with affine bookkeeping
__C.DATASET.SRC_RND_BLUR = False
__C.DATASET.SRC_RND_JITTER = 0.4
__C.DATASET.SCALE_FROM = 0.5            # source random-scale range
__C.DATASET.SCALE_TO = 1.5
__C.DATASET.TARGET_SCALE = [1.0, 1.1]   # shared initial scale for target groups
__C.DATASET.ROOT = "data/datasets"
__C.DATASET.SAMPLE_WEIGHTS = ""         # path to importance-sampling weights
__C.DATASET.SAMPLE_UNIFORM_PRIOR = 0.25  # 1 = uniform, 0 = fully weighted
__C.DATASET.MEAN = [0.485, 0.456, 0.406]
__C.DATASET.STD = [0.229, 0.224, 0.225]
__C.DATASET.RENORM_SOURCE = True        # renormalise source to target statistics
__C.DATASET.SOURCE_MEAN = [0.481, 0.479, 0.465]   # GTA
__C.DATASET.SOURCE_STD = [0.243, 0.239, 0.237]
__C.DATASET.TARGET_MEAN = [0.300, 0.344, 0.297]   # Cityscapes
__C.DATASET.TARGET_STD = [0.175, 0.180, 0.177]

# ---------------------------------------------------------------------------
# Model options (reference: core/config.py:130-159)
# ---------------------------------------------------------------------------
__C.MODEL = AttrDict()
__C.MODEL.ARCH = "resnet38_fcn"
__C.MODEL.INIT_MODEL = ""
__C.MODEL.BASELINE = False
__C.MODEL.LR_TARGET = 1.0               # multiplier for the target loss
__C.MODEL.OPT = "SGD"
__C.MODEL.OPT_NESTEROV = False
__C.MODEL.LR = 3e-4
__C.MODEL.BETA1 = 0.5
__C.MODEL.MOMENTUM = 0.9
__C.MODEL.WEIGHT_DECAY = 1e-5
__C.MODEL.STAT_MOMENTUM = 0.99          # gamma_chi: moving class prior momentum
__C.MODEL.NET_MOMENTUM = 0.99           # gamma_psi: teacher EMA momentum
__C.MODEL.NET_MOMENTUM_ITER = 100       # teacher update interval (iterations)
__C.MODEL.CONF_DISCOUNT = True
__C.MODEL.CONF_POOL_ON = True
__C.MODEL.CONF_POOL = "avg_pool"
__C.MODEL.FOCAL_P = 3
__C.MODEL.LOSS = "focal_ce_conf"
__C.MODEL.RUN_CONF_MOMENT = 0.9
__C.MODEL.RUN_CONF_UPPER = 0.75
__C.MODEL.RUN_CONF_LOWER = 0.2
__C.MODEL.THRESHOLD_BETA = 1e-3         # beta: class prior divisor in thresholds

# ---------------------------------------------------------------------------
# Logging options (reference: core/config.py:164-167)
# ---------------------------------------------------------------------------
__C.LOG = AttrDict()
__C.LOG.ITER_VAL = 2
__C.LOG.ITER_TRAIN = 10
__C.LOG.ITER_TARGET = 4

# ---------------------------------------------------------------------------
# TensorBoard-style visualisation options (reference: core/config.py:172-173)
# ---------------------------------------------------------------------------
__C.TB = AttrDict()
__C.TB.IM_SIZE = (256, 256)

# ---------------------------------------------------------------------------
# TPU-specific options (no reference counterpart; see the module docstring
# for what each does on one GPU)
# ---------------------------------------------------------------------------
__C.TPU = AttrDict()
# number of devices along the data-parallel mesh axis; 0 = all visible devices
__C.TPU.MESH_DEVICES = 0
# multi-device partitioning strategy: "shard_map" (per-shard step bodies
# with explicit in-step collectives — reference-DDP semantics, pod-ready) or
# "gspmd" (ONE global-batch step jitted with input shardings over a 2-D
# (data, sp) mesh; XLA partitions the computation, inserting conv halo
# exchanges — single-device semantics at any mesh shape, single process)
__C.TPU.PARTITION = "shard_map"
# gspmd only: devices along the spatial (image-height) mesh axis; the crop
# height shards over it, letting crops too large for one chip's HBM train
# across chips (the training counterpart of infer_val --spatial); total
# devices = data x sp
__C.TPU.MESH_SP = 1
# compute dtype for conv/matmul activations ("bfloat16" or "float32");
# parameters and BN statistics are always float32
__C.TPU.COMPUTE_DTYPE = "bfloat16"
# remat (activation checkpointing): "none" keeps all activations — measured
# 3.5% faster than "block" (599 vs 621 ms/step) and the full flagship batch
# fits a 16G v5e chip because the source/target branches run sequentially
# (train/steps.py); "block" (checkpointed residual blocks / VGG stage
# chunks) buys HBM headroom at larger batches; "convs" saves conv outputs
# and recomputes only the frozen-BN/ReLU elementwise chain in backward
# (gradients identical in every mode)
__C.TPU.REMAT = "none"
# precision of the no-grad teacher refine/pseudo-label chain: "bfloat16"
# (measured 3.5% faster: 579 vs 599 ms/step, HBM 476->440 GB; pseudo-labels
# agree with f32 on >98% of labeled pixels — PARITY.md) or "float32"
# (reference-exact interpolation)
__C.TPU.REFINE_DTYPE = "bfloat16"
# resolution of the no-grad teacher refine chain: "stride8" (measured 3.5%
# faster: 408 vs 422 ms/step, HBM 300->277 GB — softmax/warp/pool at the
# teacher logits' native grid, one upsample of the pooled result at the
# end; interior pseudo-labels agree >99.99% with the full chain —
# PARITY.md) or "full" (reference-exact op order — upsample first)
__C.TPU.REFINE_RES = "stride8"
# rematerialize the CE losses' full-res f32 log-softmax maps in backward
# instead of saving them (elementwise recompute for HBM traffic)
__C.TPU.CKPT_LOSS = False
# CE-loss map precision: "float32" (default) or "bfloat16" (log-softmax/
# one-hot maps in bf16, per-pixel NLL + reductions in f32 — gradient-
# carrying, so NOT flipped by default; measurement in PARITY.md)
__C.TPU.LOSS_DTYPE = "float32"
# CE NLL implementation: "xla" (log-softmax map saved as backward residual)
# or "pallas" (fused ops/ce.py kernel, softmax recomputed in backward — no
# materialized f32 log-softmax maps; f32-roundoff-identical)
__C.TPU.CE_IMPL = "xla"
# bilinear-upsample formulation: "matmul" (MXU interpolation-matrix
# contractions — measured 579->422 ms/step, identical weights) or "gather"
# (the original two-gather lerp)
__C.TPU.RESIZE_METHOD = "matmul"
# host data pipeline: number of decode threads and prefetch depth
__C.TPU.LOADER_THREADS = 8
__C.TPU.PREFETCH = 2
# decode and resize PNGs with the native C++ library (native/dasac_io.cpp,
# built at first use into build/native/; a failed build raises)
__C.TPU.NATIVE_LOADER = True
# serve splits from <DATASET.ROOT>/packed memmap packs when one matching the
# split/size exists (see dasac_tpu/tools/pack_dataset.py); "" disables
__C.TPU.PACKED_DIR = "auto"
# persistent XLA compile cache: restarts (preemption resume, re-launch with
# unchanged config) skip the multi-minute step compile; "" disables
__C.TPU.COMPILE_CACHE = "~/.cache/dasac_tpu/xla"


def assert_and_infer_cfg():
    cfg.immutable(True)


def merge_cfg_from_file(cfg_filename):
    """Load a YAML config file and merge it into the global config."""
    yaml_cfg = AttrDict(_to_attrdict(yaml_subset.load(cfg_filename)))
    _merge_a_into_b(yaml_cfg, __C)


cfg_from_file = merge_cfg_from_file


def merge_cfg_from_cfg(cfg_other):
    _merge_a_into_b(cfg_other, __C)


def merge_cfg_from_list(cfg_list):
    """Merge ``[KEY value KEY value ...]`` pairs (e.g. from ``--set``) into cfg."""
    assert len(cfg_list) % 2 == 0, "--set requires KEY VALUE pairs"
    for full_key, v in zip(cfg_list[0::2], cfg_list[1::2]):
        key_list = full_key.split(".")
        d = __C
        for subkey in key_list[:-1]:
            assert subkey in d, "Non-existent key: {}".format(full_key)
            d = d[subkey]
        subkey = key_list[-1]
        assert subkey in d, "Non-existent key: {}".format(full_key)
        value = _decode_cfg_value(v)
        value = _coerce_value(value, d[subkey], full_key)
        d[subkey] = value


cfg_from_list = merge_cfg_from_list


def _to_attrdict(obj):
    if isinstance(obj, dict):
        return AttrDict({k: _to_attrdict(v) for k, v in obj.items()})
    return obj


def _merge_a_into_b(a, b, stack=None):
    assert isinstance(a, AttrDict) and isinstance(b, AttrDict)
    for k, v_ in a.items():
        full_key = ".".join(stack + [k]) if stack is not None else k
        if k not in b:
            raise KeyError("Non-existent config key: {}".format(full_key))
        v = _decode_cfg_value(copy.deepcopy(v_))
        v = _coerce_value(v, b[k], full_key)
        if isinstance(v, AttrDict):
            _merge_a_into_b(v, b[k], stack=(stack or []) + [k])
        else:
            b[k] = v


def _decode_cfg_value(v):
    """Decode a raw YAML/CLI value into a Python object."""
    if isinstance(v, dict) and not isinstance(v, AttrDict):
        return AttrDict(_to_attrdict(v))
    if not isinstance(v, str):
        return v
    try:
        v = literal_eval(v)
    except (ValueError, SyntaxError):
        pass  # v genuinely is a string (e.g. a path)
    return v


def _coerce_value(value_a, value_b, full_key):
    """Coerce ``value_a`` to the type of the default it replaces."""
    type_a, type_b = type(value_a), type(value_b)
    if type_a is type_b:
        return value_a
    if isinstance(value_b, str):
        return str(value_a)
    if isinstance(value_a, tuple) and isinstance(value_b, list):
        return list(value_a)
    if isinstance(value_a, list) and isinstance(value_b, tuple):
        return tuple(value_a)
    # int -> float promotion (YAML writes `5` where the default is `5.0`)
    if isinstance(value_a, int) and isinstance(value_b, float):
        return float(value_a)
    raise ValueError(
        "Type mismatch ({} vs. {}) with values ({} vs. {}) for key: {}".format(
            type_b, type_a, value_b, value_a, full_key
        )
    )


def cfg_snapshot():
    """Deep copy of the current config as plain nested dicts (for checkpoints)."""

    def _plain(d):
        return {
            k: _plain(v) if isinstance(v, dict) else copy.deepcopy(v)
            for k, v in d.items()
        }

    return _plain(__C)


def reset_cfg():
    """Restore all config values to their defaults (used by tests)."""
    global _DEFAULT_SNAPSHOT
    cfg.immutable(False)

    def _restore(d, snap):
        for k, v in snap.items():
            if isinstance(v, dict):
                _restore(d[k], v)
            else:
                d[k] = copy.deepcopy(v)

    _restore(__C, _DEFAULT_SNAPSHOT)


_DEFAULT_SNAPSHOT = cfg_snapshot()
