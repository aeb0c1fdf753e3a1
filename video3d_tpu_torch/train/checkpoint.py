"""Checkpointing with the HF-Trainer-style layout and auto-resume.

Counterpart of ``video3d_tpu/train/checkpoint.py``, whose orbax calls
become ``torch.save`` / ``torch.load`` of the whole state (nested dicts,
lists and NamedTuples of tensors and ints): ``output_dir/checkpoint-{step}/
state.pt``, auto-resume from the newest one (train_3d.py:1863-1864), and
the final params-only export ``output_dir/model/params.pt``.
"""

from __future__ import annotations

import os
import re
from typing import Any, Optional

import torch

from video3d_tpu_torch.train.optim import tree_leaves

STATE_FILE = "state.pt"
PARAMS_FILE = "params.pt"


def latest_checkpoint(output_dir: str) -> Optional[str]:
    """Newest ``checkpoint-*`` dir under output_dir (train_3d.py:1863)."""
    if not os.path.isdir(output_dir):
        return None
    best, best_step = None, -1
    for name in os.listdir(output_dir):
        m = re.fullmatch(r"checkpoint-(\d+)", name)
        if m and int(m.group(1)) > best_step:
            best, best_step = os.path.join(output_dir, name), int(m.group(1))
    return best


def _save(path: str, obj: Any) -> str:
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, f".tmp.{os.getpid()}")
    torch.save(obj, tmp)
    return tmp


def save_checkpoint(output_dir: str, step: int, state: Any) -> str:
    path = os.path.join(os.path.abspath(output_dir), f"checkpoint-{step}")
    os.replace(_save(path, state), os.path.join(path, STATE_FILE))
    return path


def restore_checkpoint(path: str, target: Any) -> Any:
    """The state saved under ``path``, on the device of ``target``'s first
    parameter (the saved dtypes are kept; a LoRA tree's None positions
    stay None)."""
    return torch.load(os.path.join(os.path.abspath(path), STATE_FILE),
                      map_location=tree_leaves(target.params)[0].device,
                      weights_only=False)


def save_params_only(output_dir: str, params: Any, name: str = "model") -> str:
    """Final model export (train_3d.py:1871-1888 equivalent)."""
    path = os.path.join(os.path.abspath(output_dir), name)
    os.replace(_save(path, params), os.path.join(path, PARAMS_FILE))
    return path

