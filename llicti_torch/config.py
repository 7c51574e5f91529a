"""Model configuration of the port.

The port's own copy of the JAX package's ``ModelConfig``
(``llicti_tpu/config.py:17-113``): the same fields, defaults, validation
and derived properties, so that configurations written for one package
mean the same in the other.  The port imports nothing of the JAX package.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


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
