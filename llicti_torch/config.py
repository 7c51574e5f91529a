"""Configuration of the port: model, training, data and experiment.

The port's own copy of the JAX package's configuration
(``llicti_tpu/config.py``): ``ModelConfig``, ``TrainConfig``,
``DataConfig`` and ``LLICTIConfig`` with the same fields, defaults,
validation and derived properties, and ``config_from_dict`` /
``config_from_json`` with the reference JSON keys, so that configurations
written for one package mean the same in the other.  The port imports
nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Any, Tuple


@dataclass(frozen=True)
class ModelConfig:
    """Model hyper-parameters (reference: graphs/models/LLICTI_nets.py knobs)."""

    ycocg: bool = True
    clrchs: int = 3
    # 0: all color channels independent, 1: Y indep + CoCg joint,
    # 2: all 3 joint PixelCNN++-style (reference LLICTI_nets.py:21)
    clr_joint_mode: int = 2
    clrjnt0seqmd: bool = False
    mwsa_joint: bool = False
    chs: Tuple[int, ...] = (88, 1, 1, 1, 1)
    conv_layers: int = 3
    combine_layers1toL: bool = False
    evens: Tuple[int, ...] = (4, 4, 4, 4, 4)
    odds: Tuple[int, ...] = (3, 3, 3, 3, 3)
    dwtlevels: Tuple[int, ...] = (0, 1, 2, 3, 4)
    useprevlevNN: Tuple[bool, ...] = (False, True, True, True, True)
    wtr_type: str = "lazydwt"
    net_type: str = "regular"
    lif_prec_bits: int = 8
    ent_mdl_num: int = 4
    activfun: str = "ReLU"
    subtract_mean: bool = False
    distribution: str = "normal"  # "normal" | "logistic"
    num_mixtures: int = 5

    def __post_init__(self):
        # every knob is either exercised or rejected loudly
        if self.wtr_type != "lazydwt":
            raise NotImplementedError(
                f"wtr_type={self.wtr_type!r}: only 'lazydwt' is "
                "implemented (the reference's 'x' branch is an empty "
                "placeholder)")
        if self.net_type != "regular":
            raise NotImplementedError(
                f"net_type={self.net_type!r}: only 'regular' exists")
        if self.distribution not in ("normal", "logistic"):
            raise NotImplementedError(
                f"distribution={self.distribution!r}")
        if self.ent_mdl_num != 4:
            raise NotImplementedError(
                f"ent_mdl_num={self.ent_mdl_num}: only the live "
                "LLICTIEntropyModel4 (4) exists")

    @property
    def num_scales(self) -> int:
        return len(self.dwtlevels)

    @property
    def rndfactor(self) -> float:
        return 255.0 * (2 ** (self.lif_prec_bits - 8))

    @property
    def mean_y_ycocg(self) -> float:
        """127/255 for 8 bits."""
        return ((2 ** (self.lif_prec_bits - 1)) - 1) / ((2 ** self.lif_prec_bits) - 1)

    @property
    def cond_channels(self) -> int:
        """Channels per band unit ("c" in the reference)."""
        if self.clrchs == 3 and self.clr_joint_mode in (0, 2):
            return 3
        if self.clrchs == 3 and self.clr_joint_mode == 1:
            return 4
        return 1

    @property
    def model_index(self) -> Tuple[int, ...]:
        """Scale index -> interpolator-model index (useprevlevNN sharing):
        model 0 serves scale 0; each later scale gets a new model only when
        useprevlevNN[scale] is False."""
        idx = []
        m = 0
        for s in range(self.num_scales):
            if s > 0 and not self.useprevlevNN[s]:
                m += 1
            idx.append(m)
        return tuple(idx)

    @property
    def num_models(self) -> int:
        return self.model_index[-1] + 1 if self.num_scales else 0


@dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 32
    patches_per_img: int = 1
    patch_size: int = 160
    grad_acc_iters: int = 2
    loss_prnt_iters: int = 2000
    val_batch_size: int = 1
    val_patch_size: int = 0
    learning_rate: float = 1.0e-4
    max_epoch: int = 45
    validate_every: int = 1
    seed: int = 1337
    resume_training: bool = False
    checkpoint_file: str = "checkpoint"
    # ReduceLROnPlateau knobs (reference agents/llicti_agent.py:30-32)
    lr_factor: float = 0.5
    lr_patience: int = 16
    lr_cooldown: int = 15
    lr_min: float = 2.5e-5
    lr_threshold: float = 1e-4
    grad_clip_value: float = 5.0
    # data-parallel sharding
    num_data_shards: int = 1


@dataclass(frozen=True)
class DataConfig:
    train_dirs: Tuple[str, ...] = ()
    valid_dir: str = ""
    test_dir: str = ""
    dl_numworkers: int = 2
    synthetic: bool = False  # use the deterministic synthetic dataset
    synthetic_len: int = 256


@dataclass(frozen=True)
class LLICTIConfig:
    exp_name: str = "exp"
    mode: str = "train"  # train|validate|test|eval_model|model_size|flops_est|debug
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    data: DataConfig = field(default_factory=DataConfig)
    experiments_root: str = "experiments"
    extra: Any = None

    @property
    def exp_dir(self) -> str:
        return os.path.join(self.experiments_root, self.exp_name)

    @property
    def checkpoint_dir(self) -> str:
        return os.path.join(self.exp_dir, "checkpoints")

    @property
    def log_dir(self) -> str:
        return os.path.join(self.exp_dir, "logs")

    @property
    def out_dir(self) -> str:
        return os.path.join(self.exp_dir, "out")


# --- reference-JSON compatibility -------------------------------------------

_MODEL_KEYS = {
    "ycocg": "ycocg",
    "clrchs": "clrchs",
    "clr_joint_mode": "clr_joint_mode",
    "clrjnt0seqmd": "clrjnt0seqmd",
    "mwsa_joint": "mwsa_joint",
    "chs": "chs",
    "conv_layers": "conv_layers",
    "combine_layers1toL": "combine_layers1toL",
    "Evens": "evens",
    "Odds": "odds",
    "dwtlevels": "dwtlevels",
    "useprevlevNN": "useprevlevNN",
    "wtr_type": "wtr_type",
    "net_type": "net_type",
    "lif_prec_bits": "lif_prec_bits",
    "ent_mdl_num": "ent_mdl_num",
    "activfun": "activfun",
    "subtract_mean": "subtract_mean",
    "distribution": "distribution",
    "num_mixtures": "num_mixtures",
}

_TRAIN_KEYS = {
    "batch_size": "batch_size",
    "patches_per_img": "patches_per_img",
    "patch_size": "patch_size",
    "grad_acc_iters": "grad_acc_iters",
    "loss_prnt_iters": "loss_prnt_iters",
    "val_batch_size": "val_batch_size",
    "val_patch_size": "val_patch_size",
    "learning_rate": "learning_rate",
    "max_epoch": "max_epoch",
    "validate_every": "validate_every",
    "seed": "seed",
    "resume_training": "resume_training",
    "checkpoint_file": "checkpoint_file",
}


def _tupleize(v):
    return tuple(v) if isinstance(v, list) else v


def config_from_dict(d: dict) -> LLICTIConfig:
    """Build a config from a dict using reference JSON keys.

    Accepts both reference-style flat JSON (configs/llicti_A.json) and our
    nested format ({"model": {...}, "train": {...}, "data": {...}}).
    """
    if "model" in d and isinstance(d["model"], dict):
        model = ModelConfig(**{k: _tupleize(v) for k, v in d["model"].items()})
        train = TrainConfig(**d.get("train", {}))
        data = DataConfig(**{k: _tupleize(v) for k, v in d.get("data", {}).items()})
        return LLICTIConfig(
            exp_name=d.get("exp_name", "exp"),
            mode=d.get("mode", "train"),
            model=model,
            train=train,
            data=data,
            experiments_root=d.get("experiments_root", "experiments"),
        )

    model_kwargs = {}
    for ref_key, our_key in _MODEL_KEYS.items():
        if ref_key in d:
            model_kwargs[our_key] = _tupleize(d[ref_key])
    train_kwargs = {}
    for ref_key, our_key in _TRAIN_KEYS.items():
        if ref_key in d:
            train_kwargs[our_key] = d[ref_key]
    train_dirs = []
    for i in range(1, 1 + int(d.get("num_train_dirs", 0))):
        k = f"train_data_{i}"
        if k in d:
            train_dirs.append(d[k])
    data_kwargs = dict(
        train_dirs=tuple(train_dirs),
        valid_dir=d.get("valid_data", ""),
        test_dir=d.get("test_data", ""),
        dl_numworkers=d.get("dl_numworkers", 2),
    )
    exp_name = d.get("exp_name") or d.get("multi_exp_name", "exp")
    known = set(_MODEL_KEYS) | set(_TRAIN_KEYS)
    extra = {k: v for k, v in d.items() if k not in known}
    return LLICTIConfig(
        exp_name=exp_name,
        mode=d.get("mode", "train"),
        model=ModelConfig(**model_kwargs),
        train=TrainConfig(**train_kwargs),
        data=DataConfig(**data_kwargs),
        extra=extra,
    )


def config_from_json(path: str) -> LLICTIConfig:
    with open(path, "r") as f:
        return config_from_dict(json.load(f))


def replace(cfg, **kw):
    """dataclasses.replace passthrough (convenience)."""
    return dataclasses.replace(cfg, **kw)
