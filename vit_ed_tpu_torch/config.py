"""Configuration tree for vit_ed_tpu_torch.

The port's own copy of ``vit_ed_tpu/config.py``: the same key tree (so
every YAML under ``configs/`` loads unchanged, TPU.* keys included), the
same recursive BASE inheritance and the same ``--opts KEY VALUE`` merges.
Keys that name features this slice leaves out stay in the tree; the model
factory (models/build.py) raises when one of them is switched on.
"""

from __future__ import annotations

import copy
import os
from typing import Any, Dict, List, Optional

import yaml


class ConfigNode(dict):
    """An attribute-accessible dict with freeze semantics.

    Unlike yacs, type coercion on merge is minimal: values merged from YAML
    or option lists replace existing values, with literal eval applied to
    strings merged via ``merge_from_list`` (mirroring yacs behaviour).
    """

    __slots__ = ()
    _FROZEN_KEY = "__frozen__"

    def __init__(self, init: Optional[Dict[str, Any]] = None):
        super().__init__()
        object.__setattr__  # no instance dict; state lives in the dict itself
        super().__setitem__(ConfigNode._FROZEN_KEY, False)
        if init:
            for k, v in init.items():
                self[k] = ConfigNode(v) if isinstance(v, dict) else v

    # -- attribute protocol -------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __setitem__(self, name: str, value: Any) -> None:
        if name != ConfigNode._FROZEN_KEY and self.is_frozen():
            raise AttributeError(f"Attempted to set {name} on a frozen ConfigNode")
        super().__setitem__(name, value)

    # -- freeze protocol ----------------------------------------------------
    def is_frozen(self) -> bool:
        return super().get(ConfigNode._FROZEN_KEY, False)

    def freeze(self) -> "ConfigNode":
        self._set_frozen(True)
        return self

    def defrost(self) -> "ConfigNode":
        self._set_frozen(False)
        return self

    def _set_frozen(self, state: bool) -> None:
        super().__setitem__(ConfigNode._FROZEN_KEY, state)
        for v in self.values():
            if isinstance(v, ConfigNode):
                v._set_frozen(state)

    # -- merge protocol -----------------------------------------------------
    def merge_from_dict(self, other: Dict[str, Any]) -> None:
        frozen = self.is_frozen()
        if frozen:
            self.defrost()
        for k, v in other.items():
            if k in ("BASE", ConfigNode._FROZEN_KEY):
                continue
            if isinstance(v, dict) and isinstance(super().get(k), ConfigNode):
                self[k].merge_from_dict(v)
            elif isinstance(v, dict):
                self[k] = ConfigNode(v)
            else:
                self[k] = v
        if frozen:
            self.freeze()

    def merge_from_file(self, cfg_file: str) -> None:
        """Merge a YAML file, recursively merging its BASE files first.

        Mirrors the reference's yacs BASE handling.
        """
        if not os.path.isfile(cfg_file):
            raise SystemExit(
                f"config file not found: {cfg_file!r} — pass --cfg a YAML "
                "under configs/ (e.g. configs/hisfrag/hisfrag20_patch16_512"
                ".yaml) or check the BASE entries of the file that "
                "referenced it")
        with open(cfg_file, "r") as f:
            yaml_cfg = yaml.safe_load(f) or {}
        for base in yaml_cfg.get("BASE", [""]):
            if base:
                self.merge_from_file(os.path.join(os.path.dirname(cfg_file), base))
        self.merge_from_dict(yaml_cfg)

    def merge_from_list(self, opts: List[str]) -> None:
        """Merge dotted KEY VALUE pairs, e.g. ["TRAIN.EPOCHS", "10"]."""
        assert len(opts) % 2 == 0, f"Override list has odd length: {opts}"
        frozen = self.is_frozen()
        if frozen:
            self.defrost()
        for key, value in zip(opts[0::2], opts[1::2]):
            node = self
            parts = key.split(".")
            for p in parts[:-1]:
                if p not in node:
                    raise KeyError(f"Non-existent config key: {key}")
                node = node[p]
            leaf = parts[-1]
            if leaf not in node:
                raise KeyError(f"Non-existent config key: {key}")
            node[leaf] = _coerce(value, node[leaf])
        if frozen:
            self.freeze()

    # -- io -----------------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        out = {}
        for k, v in self.items():
            if k == ConfigNode._FROZEN_KEY:
                continue
            out[k] = v.to_dict() if isinstance(v, ConfigNode) else v
        return out

    def dump(self) -> str:
        return yaml.safe_dump(self.to_dict(), default_flow_style=False)

    def clone(self) -> "ConfigNode":
        c = ConfigNode(copy.deepcopy(self.to_dict()))
        return c


def _coerce(value: str, old: Any) -> Any:
    """Interpret a CLI string override, guided by the existing value type."""
    if not isinstance(value, str):
        return value
    if isinstance(old, bool):
        return value.lower() in ("1", "true", "yes", "on")
    if isinstance(old, int) and not isinstance(old, bool):
        try:
            return int(value)
        except ValueError:
            pass
    if isinstance(old, float):
        try:
            return float(value)
        except ValueError:
            pass
    # Fall back to YAML literal interpretation (handles lists, numbers, null)
    try:
        return yaml.safe_load(value)
    except Exception:
        return value


def default_config() -> ConfigNode:
    """The default config tree (the same keys as vit_ed_tpu.config)."""
    c = ConfigNode()

    c.BASE = [""]

    # ------------------------------ data -----------------------------------
    c.DATA = ConfigNode()
    c.DATA.BATCH_SIZE = 128
    c.DATA.TEST_BATCH_SIZE = 128
    c.DATA.DATA_PATH = ""
    c.DATA.DATASET = "imagenet"
    c.DATA.IMG_SIZE = 224
    c.DATA.INTERPOLATION = "bicubic"
    c.DATA.ZIP_MODE = False
    c.DATA.CACHE_MODE = "part"
    c.DATA.PIN_MEMORY = True
    c.DATA.NUM_WORKERS = 8
    c.DATA.EROSION_RATIO = 0.07
    c.DATA.EVAL_N_ITEMS_PER_CATEGORY = 5

    # ------------------------------ model ----------------------------------
    c.MODEL = ConfigNode()
    c.MODEL.TYPE = "pjs"
    c.MODEL.NAME = "div2k_erosion7_4bin_patch8_64"
    c.MODEL.PRETRAINED = ""
    c.MODEL.RESUME = ""
    c.MODEL.NUM_CLASSES = 1
    c.MODEL.DROP_RATE = 0.0
    c.MODEL.DROP_PATH_RATE = 0.1
    c.MODEL.LABEL_SMOOTHING = 0.1

    c.MODEL.PJS = ConfigNode()
    c.MODEL.PJS.PATCH_SIZE = 16
    c.MODEL.PJS.IN_CHANS = 3
    c.MODEL.PJS.EMBED_DIM = 768
    c.MODEL.PJS.DEPTH = 8
    c.MODEL.PJS.C_DEPTH = 8
    c.MODEL.PJS.NUM_HEADS = 12
    c.MODEL.PJS.MLP_RATIO = 4.0
    c.MODEL.PJS.QKV_BIAS = True
    c.MODEL.PJS.QK_SCALE = None
    c.MODEL.PJS.KEEP_ATTN = False
    c.MODEL.PJS.ARCH_VERSION = "v1"
    # Mixture-of-Experts encoder MLPs (dense when EXPERTS == 0)
    c.MODEL.PJS.MOE = ConfigNode()
    c.MODEL.PJS.MOE.EXPERTS = 0
    c.MODEL.PJS.MOE.INTERVAL = 2
    c.MODEL.PJS.MOE.CAPACITY = 1.25       # tokens/expert = T/E * CAPACITY
    c.MODEL.PJS.MOE.ROUTE_K = 1           # 1 = Switch top-1, 2 = GShard top-2
    c.MODEL.PJS.MOE.AUX_WEIGHT = 0.01     # Switch load-balance loss weight
    c.MODEL.PJS.MOE.Z_WEIGHT = 0.001      # ST-MoE router z-loss weight
    c.MODEL.PJS.MOE.JITTER = 0.0          # router-input jitter (train only)

    c.MODEL.VIT = ConfigNode()
    c.MODEL.VIT.PATCH_SIZE = 16
    c.MODEL.VIT.IN_CHANS = 3
    c.MODEL.VIT.EMBED_DIM = 768
    c.MODEL.VIT.DEPTH = 12
    c.MODEL.VIT.NUM_HEADS = 12
    c.MODEL.VIT.MLP_RATIO = 4.0
    c.MODEL.VIT.QKV_BIAS = True
    c.MODEL.VIT.QK_SCALE = None

    c.MODEL.SS = ConfigNode()
    c.MODEL.SS.ARCH = "resnet34"
    c.MODEL.SS.PRETRAINED = ""
    c.MODEL.SS.EMBED_DIM = 2048
    c.MODEL.SS.PRED_DIM = 512
    c.MODEL.SS.DROPOUT = 0.0
    c.MODEL.SS.N_CLASSES = 0

    c.MODEL.RES = ConfigNode()
    c.MODEL.RES.ARCH = "resnet18"
    c.MODEL.RES.PRETRAINED = ""
    c.MODEL.RES.LAYERS_FREEZE = -1

    c.MODEL.MIXCONV = ConfigNode()
    c.MODEL.MIXCONV.ARCH = "resnet18"
    c.MODEL.MIXCONV.PRETRAINED = ""
    c.MODEL.MIXCONV.MIX_DEPTH = 4
    c.MODEL.MIXCONV.OUT_ROWS = 1
    c.MODEL.MIXCONV.OUT_CHANNELS = 512
    c.MODEL.MIXCONV.LAYERS_FREEZE = -1

    c.PCA = ConfigNode()
    c.PCA.DIM = 256

    # ------------------------------ train ----------------------------------
    c.TRAIN = ConfigNode()
    c.TRAIN.START_EPOCH = 0
    c.TRAIN.EPOCHS = 300
    c.TRAIN.WARMUP_EPOCHS = 20
    c.TRAIN.WEIGHT_DECAY = 0.05
    c.TRAIN.BASE_LR = 1e-4
    c.TRAIN.WARMUP_LR = 5e-7
    c.TRAIN.MIN_LR = 5e-6
    c.TRAIN.CLIP_GRAD = 5.0
    c.TRAIN.AUTO_RESUME = True
    c.TRAIN.ACCUMULATION_STEPS = 1
    c.TRAIN.USE_CHECKPOINT = False
    c.TRAIN.LOAD_LR_SCHEDULER = True
    c.TRAIN.PREEMPT_SAVE = True
    c.TRAIN.PREEMPT_CHECK_FREQ = 1

    c.TRAIN.LR_SCHEDULER = ConfigNode()
    c.TRAIN.LR_SCHEDULER.NAME = "cosine"
    c.TRAIN.LR_SCHEDULER.DECAY_EPOCHS = 30
    c.TRAIN.LR_SCHEDULER.DECAY_RATE = 0.1
    c.TRAIN.LR_SCHEDULER.WARMUP_PREFIX = True
    c.TRAIN.LR_SCHEDULER.GAMMA = 0.1
    c.TRAIN.LR_SCHEDULER.MULTISTEPS = []

    c.TRAIN.OPTIMIZER = ConfigNode()
    c.TRAIN.OPTIMIZER.NAME = "adamw"
    c.TRAIN.OPTIMIZER.EPS = 1e-8
    c.TRAIN.OPTIMIZER.BETAS = (0.9, 0.999)
    c.TRAIN.OPTIMIZER.MOMENTUM = 0.9

    c.TRAIN.LAYER_DECAY = 1.0

    c.TRAIN.MOE = ConfigNode()
    c.TRAIN.MOE.SAVE_MASTER = False

    # ------------------------------ aug ------------------------------------
    c.AUG = ConfigNode()
    c.AUG.COLOR_JITTER = 0.4
    c.AUG.AUTO_AUGMENT = "rand-m9-mstd0.5-inc1"
    c.AUG.REPROB = 0.25
    c.AUG.REMODE = "pixel"
    c.AUG.RECOUNT = 1
    c.AUG.MIXUP = 0.0
    c.AUG.CUTMIX = 0.0
    c.AUG.CUTMIX_MINMAX = None
    c.AUG.MIXUP_PROB = 1.0
    c.AUG.MIXUP_SWITCH_PROB = 0.5
    c.AUG.MIXUP_MODE = "batch"

    # ------------------------------ test -----------------------------------
    c.TEST = ConfigNode()
    c.TEST.CROP = True
    c.TEST.SEQUENTIAL = False
    c.TEST.SHUFFLE = False

    # ------------------------------ misc -----------------------------------
    c.ENABLE_AMP = False
    c.AMP_ENABLE = True  # bf16 compute when enabled
    c.AMP_OPT_LEVEL = ""
    c.OUTPUT = ""
    c.TAG = "default"
    c.SAVE_FREQ = 1
    c.SAVE_TMP_FREQ = 5
    c.PRINT_FREQ = 50
    c.SEED = 0
    c.EVAL_MODE = False
    c.THROUGHPUT_MODE = False
    c.LOCAL_RANK = 0
    c.FUSED_WINDOW_PROCESS = False
    c.FUSED_LAYERNORM = False

    # The JAX package's deployment knobs. The port reads CLS_SHORTCUT,
    # DEVICE_NORMALIZE, USE_PALLAS_ATTENTION (must stay True: the port
    # always runs its kernel on the card), INT8_SCORE, SHARDED_EVAL_METRICS,
    # EVAL_SLAB_ON_DISK, MAX_TRAIN_PAIRS, FAST_GELU and PEAK_TFLOPS (the MFU
    # line's peak where set; the JAX default is a TPU's, the port's 0 reads
    # the card's own); models/build.py raises for the parallelism and MoE
    # switches, which are not ported yet (ROADMAP queue A item 12). The
    # rest are kept so that every YAML of configs/ loads.
    c.TPU = ConfigNode()
    c.TPU.MESH_SHAPE = []
    c.TPU.USE_PALLAS_ATTENTION = True
    c.TPU.MAX_TRAIN_PAIRS = 0
    c.TPU.DONATE_STATE = True
    c.TPU.PROFILE_DIR = ""
    c.TPU.PEAK_TFLOPS = 0.0        # the MFU line's peak; 0: read from the card
    c.TPU.FAST_GELU = False        # tanh GELU instead of the exact one
    c.TPU.INT8_SCORE = False       # int8 GEMMs in the O(N^2) scoring scan
    c.TPU.CLS_SHORTCUT = True      # last decoder block computes only the
                                   # CLS row in head-scoring paths
    c.TPU.SHARDED_EVAL_METRICS = False
    c.TPU.EVAL_SLAB_ON_DISK = False
    c.TPU.TENSOR_PARALLEL = False
    c.TPU.SEQ_PARALLEL = False
    c.TPU.RING_ATTN = False
    c.TPU.FSDP = False
    c.TPU.PIPELINE_STAGES = 0
    c.TPU.PP_MICROBATCHES = 0
    c.TPU.EXPERT_PARALLEL = False
    c.TPU.MESH_AXES = []
    c.TPU.DEVICE_NORMALIZE = False  # the eval transform emits uint8 and the
                                    # model normalizes on the device

    return c


def update_config(config: ConfigNode, args) -> None:
    """Apply CLI arguments onto the config (reference config.py:256-326)."""
    if getattr(args, "cfg", None):
        if not os.path.isfile(args.cfg):
            raise SystemExit(f"Config file not found: {args.cfg}")
        config.merge_from_file(args.cfg)

    config.defrost()

    def has(name):
        return getattr(args, name, None)

    if has("batch_size"):
        config.DATA.BATCH_SIZE = args.batch_size
        config.DATA.TEST_BATCH_SIZE = args.batch_size
    if has("eval_n_items_per_category"):
        config.DATA.EVAL_N_ITEMS_PER_CATEGORY = args.eval_n_items_per_category
    if has("data_path"):
        config.DATA.DATA_PATH = args.data_path
    if has("pretrained"):
        config.MODEL.PRETRAINED = args.pretrained
    if has("resume"):
        config.MODEL.RESUME = args.resume
    if has("keep_attn"):
        config.MODEL.PJS.KEEP_ATTN = args.keep_attn
    if has("accumulation_steps"):
        config.TRAIN.ACCUMULATION_STEPS = args.accumulation_steps
    if has("use_checkpoint"):
        config.TRAIN.USE_CHECKPOINT = True
    if has("disable_amp"):
        config.AMP_ENABLE = False
    if has("output"):
        config.OUTPUT = args.output
    if has("tag"):
        config.TAG = args.tag
    if has("eval"):
        config.EVAL_MODE = True
    if has("throughput"):
        config.THROUGHPUT_MODE = True
    if has("optim"):
        config.TRAIN.OPTIMIZER.NAME = args.optim

    config.OUTPUT = os.path.join(config.OUTPUT, config.MODEL.NAME, config.TAG)

    if getattr(args, "opts", None):
        config.merge_from_list(args.opts)

    config.freeze()


def get_config(args) -> ConfigNode:
    """Build a frozen config from defaults + YAML + CLI args."""
    config = default_config()
    update_config(config, args)
    return config
