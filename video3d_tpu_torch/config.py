"""Configuration of the port: the JAX package's config dataclasses, which
hold no JAX, re-exported so that a user of the port imports only
``video3d_tpu_torch``."""

from video3d_tpu.config import (DataConfig, LLMConfig, ModelConfig,  # noqa: F401
                                VisionConfig)
