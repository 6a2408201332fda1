r"""
Package-wide configuration management.

A yacs-compatible, YAML-backed, frozen nested configuration with the exact key
surface of the reference implementation (reference ``probnmn/config.py:46-237``):
the same defaults, the same ``Config(config_yaml, config_override)`` constructor,
attribute access, ``dump()`` and dotted-key override lists. The reference shipped
YAML files in ``configs/`` load unchanged.

Implemented without yacs (pure PyYAML) so the dependency surface stays tiny.
"""
from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional

import yaml


class ConfigNode:
    r"""A nested, freezable dict with attribute access (a minimal yacs CfgNode)."""

    def __init__(self, init: Optional[Dict[str, Any]] = None):
        object.__setattr__(self, "_frozen", False)
        object.__setattr__(self, "_fields", {})
        if init:
            for key, value in init.items():
                self[key] = value

    # -- dict-like access -------------------------------------------------------------------
    def __getitem__(self, key: str) -> Any:
        return self._fields[key]

    def __setitem__(self, key: str, value: Any) -> None:
        if self._frozen:
            raise AttributeError(f"ConfigNode is frozen, cannot set {key}")
        if isinstance(value, dict):
            value = ConfigNode(value)
        self._fields[key] = value

    def __contains__(self, key: str) -> bool:
        return key in self._fields

    def keys(self):
        return self._fields.keys()

    def items(self):
        return self._fields.items()

    # -- attribute access -------------------------------------------------------------------
    def __getattr__(self, key: str) -> Any:
        if key.startswith("_"):
            raise AttributeError(key)
        try:
            return self._fields[key]
        except KeyError:
            raise AttributeError(f"No config key: {key}")

    def __setattr__(self, key: str, value: Any) -> None:
        if key.startswith("_"):
            object.__setattr__(self, key, value)
        else:
            self[key] = value

    # -- merge / freeze ---------------------------------------------------------------------
    def merge_from_dict(self, other: Dict[str, Any], prefix: str = "") -> None:
        for key, value in other.items():
            full_key = f"{prefix}{key}"
            if key not in self._fields:
                raise KeyError(f"Non-existent config key: {full_key}")
            current = self._fields[key]
            if isinstance(current, ConfigNode):
                if not isinstance(value, dict):
                    raise TypeError(f"Cannot override config section {full_key} with a scalar.")
                current.merge_from_dict(value, prefix=f"{full_key}.")
            else:
                self._fields[key] = _coerce(value, current, full_key)

    def merge_from_list(self, override_list: List[Any]) -> None:
        if len(override_list) % 2 != 0:
            raise ValueError("Override list must have even length: [KEY, value, ...]")
        for dotted_key, value in zip(override_list[0::2], override_list[1::2]):
            node = self
            *parents, leaf = dotted_key.split(".")
            for part in parents:
                if not isinstance(node, ConfigNode) or part not in node._fields:
                    raise KeyError(f"Non-existent config section in key: {dotted_key}")
                node = node._fields[part]
            if leaf not in node._fields:
                raise KeyError(f"Non-existent config key: {dotted_key}")
            if isinstance(value, str):
                value = yaml.safe_load(value)
            node._fields[leaf] = _coerce(value, node._fields[leaf], dotted_key)

    def freeze(self) -> None:
        object.__setattr__(self, "_frozen", True)
        for value in self._fields.values():
            if isinstance(value, ConfigNode):
                value.freeze()

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for key, value in self._fields.items():
            out[key] = value.to_dict() if isinstance(value, ConfigNode) else copy.copy(value)
        return out

    def __str__(self) -> str:
        return yaml.safe_dump(self.to_dict(), default_flow_style=None, sort_keys=False).rstrip()

    __repr__ = __str__


def _coerce(value: Any, reference: Any, key: str) -> Any:
    r"""Coerce an override ``value`` towards the type of the default ``reference``."""
    if reference is None or value is None:
        return value
    if isinstance(reference, bool):
        if isinstance(value, bool):
            return value
        raise TypeError(f"Expected bool for {key}, got {type(value).__name__}")
    if isinstance(reference, float) and isinstance(value, int):
        return float(value)
    if isinstance(reference, int) and isinstance(value, float) and value.is_integer():
        return int(value)
    if isinstance(reference, (list, tuple)):
        return list(value)
    if not isinstance(value, type(reference)) and not isinstance(reference, type(value)):
        raise TypeError(
            f"Type mismatch for {key}: expected {type(reference).__name__}, "
            f"got {type(value).__name__}"
        )
    return value


class Config:
    r"""
    Immutable package-wide configuration, mirroring the reference key surface
    (``config.py:48-217`` in the reference). Defaults correspond to ``joint_training``.

    Parameters
    ----------
    config_yaml: str, optional
        Path to a YAML file with parameters to override.
    config_override: List[Any], optional
        Flat list of alternating dotted keys and values, applied after the YAML file.

    Examples
    --------
    >>> _C = Config("config.yaml", ["OPTIM.BATCH_SIZE", 2048, "BETA", 0.7])
    >>> _C.OPTIM.BATCH_SIZE
    2048
    """

    def __init__(self, config_yaml: Optional[str] = None, config_override: List[Any] = []):
        _C = ConfigNode()

        # Random seed for NumPy and torch, important for reproducibility (the supervision
        # subset selection is a deterministic function of this seed).
        _C.RANDOM_SEED = 0

        # One of "program_prior", "question_coding", "module_training", "joint_training".
        _C.PHASE = "joint_training"

        # Number of training examples with paired ground-truth programs.
        _C.SUPERVISION = 1000
        # Maximum question length considered when choosing the supervised subset.
        _C.SUPERVISION_QUESTION_MAX_LENGTH = 40

        # "baseline" - use only supervised examples; "ours" - semi-supervised objective.
        _C.OBJECTIVE = "ours"

        _C.DATA = {
            "VOCABULARY": "data/clevr_vocabulary",
            "TRAIN": {},
            "VAL": {},
            "TEST": {},
            "TRAIN_TOKENS": "data/clevr_train_tokens.h5",
            "TRAIN_FEATURES": "data/clevr_train_features.h5",
            "VAL_TOKENS": "data/clevr_val_tokens.h5",
            "VAL_FEATURES": "data/clevr_val_features.h5",
            "TEST_TOKENS": "data/clevr_test_tokens.h5",
            "TEST_FEATURES": "data/clevr_test_features.h5",
        }

        _C.PROGRAM_PRIOR = {
            "INPUT_SIZE": 256, "HIDDEN_SIZE": 256, "NUM_LAYERS": 2, "DROPOUT": 0.0,
        }
        _C.PROGRAM_GENERATOR = {
            "INPUT_SIZE": 256, "HIDDEN_SIZE": 256, "NUM_LAYERS": 2, "DROPOUT": 0.0,
        }
        _C.QUESTION_RECONSTRUCTOR = {
            "INPUT_SIZE": 256, "HIDDEN_SIZE": 256, "NUM_LAYERS": 2, "DROPOUT": 0.0,
        }
        _C.NMN = {
            "IMAGE_FEATURE_SIZE": [1024, 14, 14],
            "MODULE_CHANNELS": 128,
            "CLASS_PROJECTION_CHANNELS": 1024,
            "CLASSIFIER_LINEAR_SIZE": 1024,
            # Conv/matmul compute dtype for the NMN stack (new key, no
            # reference counterpart — torch runs f32). "auto" selects bfloat16
            # when the engine runs on a CUDA device (bf16 operands, f32
            # accumulation; answer logits stay f32) and float32 on the CPU.
            # Set "float32" to force strict f32.
            "COMPUTE_DTYPE": "auto",
        }

        # Loss coefficients (names as per paper equations).
        _C.ALPHA = 100.0   # supervision scaling
        _C.BETA = 0.1      # KL coefficient
        _C.GAMMA = 1.0     # answer log-likelihood scaling (joint training)
        _C.DELTA = 0.99    # REINFORCE moving-average baseline decay

        _C.OPTIM = {
            "BATCH_SIZE": 256,
            "NUM_ITERATIONS": 20000,
            "WEIGHT_DECAY": 0.0,
            "LR_INITIAL": 0.00001,
            "LR_GAMMA": 0.5,
            "LR_PATIENCE": 3,
            # Extension beyond the reference (which keeps torch-Adam f32
            # moments): "bfloat16" stores Adam's first moment in bf16 to halve
            # its per-step HBM traffic on the 50M-param joint tree.
            "ADAM_MU_DTYPE": "float32",
        }

        _C.CHECKPOINTS = {
            "PROGRAM_PRIOR": "checkpoints/program_prior_best.pth",
            "QUESTION_CODING": "checkpoints/question_coding_1000_ours_best.pth",
            "MODULE_TRAINING": "checkpoints/module_training_1000_ours_best.pth",
        }

        if config_yaml is not None:
            with open(config_yaml) as f:
                overrides = yaml.safe_load(f) or {}
            _C.merge_from_dict(overrides)
        _C.merge_from_list(list(config_override))
        _C.freeze()
        object.__setattr__(self, "_C", _C)

    def dump(self, file_path: str) -> None:
        r"""Save the resolved config at the specified (YAML) file path."""
        with open(file_path, "w") as f:
            yaml.safe_dump(self._C.to_dict(), f, default_flow_style=None, sort_keys=False)

    def to_dict(self) -> Dict[str, Any]:
        return self._C.to_dict()

    def __getattr__(self, attr: str) -> Any:
        return getattr(object.__getattribute__(self, "_C"), attr)

    def __setattr__(self, attr: str, value: Any) -> None:
        raise AttributeError("Config is immutable; use config_yaml or config_override.")

    def __str__(self) -> str:
        return str(self._C)

    def __repr__(self) -> str:
        return repr(self._C)
