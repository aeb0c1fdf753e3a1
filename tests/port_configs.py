"""The port's config objects built from the same field values as the JAX
package's: the parity tests hand the JAX functions a ``video3d_tpu.config``
object and the port's functions its ``video3d_tpu_torch.config`` twin."""

import dataclasses
import enum

from video3d_tpu_torch import config as tconfig


def port_config(cfg):
    """A ``video3d_tpu.config`` dataclass or enum -> the port's class of the
    same name, built from the same (converted) field values."""
    if dataclasses.is_dataclass(cfg):
        cls = getattr(tconfig, type(cfg).__name__)
        return cls(**{f.name: port_config(getattr(cfg, f.name))
                      for f in dataclasses.fields(cfg)})
    if isinstance(cfg, enum.Enum):
        return getattr(tconfig, type(cfg).__name__)(cfg.value)
    return cfg
