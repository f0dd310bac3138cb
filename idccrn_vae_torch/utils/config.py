"""INI config surface compatible with the reference's myconf
(utils/read_config.py:15-19: a case-preserving ConfigParser).

The port's copy of `idccrn_vae_tpu/utils/config.py`; the training CLIs
read the same `configs/*.ini`, and hyperparameters go to the
checkpoint's ``meta.json`` (train/checkpoint.py), not directory names.
"""

from __future__ import annotations

import configparser
from typing import Optional


class IniConfig(configparser.ConfigParser):
    """Case-preserving ConfigParser (option names keep their case)."""

    def optionxform(self, optionstr: str) -> str:  # noqa: D102
        return optionstr


def load_ini(path: str) -> IniConfig:
    cfg = IniConfig()
    read = cfg.read(path)
    if not read:
        raise FileNotFoundError(f"config file not found: {path}")
    return cfg


def get_opt(cfg: IniConfig, section: str, option: str,
            default: Optional[str] = None) -> Optional[str]:
    if cfg.has_option(section, option):
        return cfg.get(section, option)
    return default
