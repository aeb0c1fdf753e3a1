"""Optimizer assembly: AdamW with per-module learning rates, weight-decay
groups, and cosine-with-warmup schedule, as plain tensor code over the
parameter tree.

Counterpart of ``video3d_tpu/train/optim.py``, which builds it from optax;
this module computes what that optax chain computes (not ``torch.optim``,
whose AdamW differs: decoupled decay, eps inside the bias correction, one
clip over all groups):

* ``multi_transform`` over the labels ``base`` / ``vision`` / ``projector``
  (:func:`_module_of`), each group its own chain
  ``clip_by_global_norm -> scale_by_adam (f32 moments, eps outside the
  sqrt) -> add_decayed_weights (no-decay mask) -> scale_by_schedule
  (warmup-cosine from 0) -> scale(-lr)``. A group's chain sees only its own
  leaves, so each group is clipped by its own global norm;
* ``masked(set_to_zero)`` on the leaves outside ``tunable_prefixes`` (they
  still count in their group's norm and moments, as in optax);
* :class:`MultiSteps`: the running mean of k mini-batch gradients, zero
  updates on the first k - 1 mini-steps, the inner update on the k-th.

Scalars (bias corrections, the schedule) are computed in float32, as under
JAX. The update is computed in the gradient tensors' own buffers (the
gradients are consumed) and :func:`apply_updates` adds it to the parameters
in place: at full width every tree of f32 leaves is ~10 GB.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

Params = Any


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    learning_rate: float = 1e-5
    mm_vision_tower_lr: Optional[float] = 2e-6
    mm_projector_lr: Optional[float] = None
    weight_decay: float = 0.0
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    warmup_ratio: float = 0.03
    total_steps: int = 1000
    max_grad_norm: float = 1.0
    # modules to train; mirrors mm_tunable_parts. Paths are tree prefixes.
    tunable_prefixes: Tuple[str, ...] = ("llm", "projector", "vision",
                                         "image_newline", "ground_head",
                                         "world_pe_mlp")


def tree_leaves_with_path(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) pairs in JAX's flattening order (dict keys sorted, list
    items in order), paths joined by "/" as ``optim._path_str`` does. None
    is an empty subtree, as in a JAX pytree: a LoRA trainable tree holds
    None at every position that is not trained."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [pl for k in sorted(tree) for pl in tree_leaves_with_path(
            tree[k], f"{prefix}/{k}" if prefix else str(k))]
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree) for pl in tree_leaves_with_path(
            v, f"{prefix}/{i}" if prefix else str(i))]
    return [(prefix, tree)]


def tree_leaves(tree) -> List[Any]:
    return [leaf for _, leaf in tree_leaves_with_path(tree)]


def tree_unflatten(like, leaves) -> Any:
    """A tree shaped like ``like`` with ``leaves`` (in flattening order);
    None positions of ``like`` stay None."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return [build(v) for v in node]
        return next(it)

    return build(like)


def global_norm(leaves) -> torch.Tensor:
    """sqrt of the sum over leaves of sum(x^2), in f32 (optax.global_norm)."""
    total = sum(torch.sum(x.float() * x.float()) for x in leaves)
    return torch.sqrt(total)


def _f32(x, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


def _as_f32(x: float) -> float:
    """x rounded to float32, as a Python float."""
    return float(torch.tensor(x, dtype=torch.float32))


def cosine_warmup_schedule(cfg: OptimConfig, peak_lr: float, count: int,
                           device=None) -> torch.Tensor:
    """optax ``warmup_cosine_decay_schedule(init_value=0, peak_value=
    peak_lr, warmup_steps, decay_steps=total, end_value=0)`` at ``count``,
    in f32; its value at count 0 is 0."""
    warmup = max(1, int(cfg.total_steps * cfg.warmup_ratio))
    # optax's cosine phase spans (decay_steps - warmup_steps), which must be
    # positive (the JAX package guards tiny runs the same way)
    total = max(cfg.total_steps, warmup + 1)
    if count < warmup:                       # linear_schedule(0, peak)
        c = _f32(min(max(count, 0), warmup), device)
        frac = 1 - c / warmup
        return (0.0 - peak_lr) * frac + peak_lr
    decay_steps = float(total - warmup)      # cosine_decay_schedule(peak)
    c = torch.minimum(_f32(count - warmup, device), _f32(decay_steps, device))
    cosine = 0.5 * (1 + torch.cos(math.pi * c / decay_steps))
    return peak_lr * ((1 - 0.0) * cosine + 0.0)


def _module_of(path: str) -> str:
    if path.startswith("vision"):
        return "vision"
    if path.startswith("projector") or path.startswith("image_newline") \
            or path.startswith("world_pe_mlp"):
        return "projector"
    return "base"


def _no_decay(path: str, param) -> bool:
    """Biases and 1-D norm/scale params get no weight decay."""
    leaf = path.split("/")[-1]
    return param.dim() <= 1 or leaf.startswith("b") or "ln" in leaf \
        or "norm" in leaf


class AdamWState(NamedTuple):
    """One group's chain state: the Adam count (the schedule's count is the
    same number) and the f32 moments of the group's leaves."""

    count: int
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


class AdamW:
    """The JAX package's ``build_optimizer`` chain over a parameter tree:
    ``init(params)`` -> state, ``update(grads, state, params)`` ->
    (updates, state). Trees are nested dicts / lists of tensors."""

    GROUPS = ("base", "vision", "projector")

    def __init__(self, params: Params, cfg: OptimConfig):
        self.cfg = cfg
        paths = tree_leaves_with_path(params)
        labels = [_module_of(p) for p, _ in paths]
        #: leaf indices of each group, in flattening order
        self.groups = {g: [i for i, lab in enumerate(labels) if lab == g]
                       for g in self.GROUPS}
        self.decay = [not _no_decay(p, x) for p, x in paths]
        self.trainable = [any(p.startswith(t) for t in cfg.tunable_prefixes)
                          for p, _ in paths]
        self.lr = {"base": cfg.learning_rate,
                   "vision": cfg.mm_vision_tower_lr or cfg.learning_rate,
                   "projector": cfg.mm_projector_lr or cfg.learning_rate}

    def init(self, params: Params) -> Dict[str, AdamWState]:
        leaves = tree_leaves(params)
        return {g: AdamWState(
            0, [torch.zeros_like(leaves[i], dtype=torch.float32)
                for i in idx],
            [torch.zeros_like(leaves[i]) for i in idx])
            for g, idx in self.groups.items()}

    def update(self, grads: Params, state: Dict[str, AdamWState],
               params: Params) -> Tuple[Params, Dict[str, AdamWState]]:
        """The updates, written into the gradients' buffers; moments are
        updated in place and returned in the new state."""
        cfg = self.cfg
        g_leaves, p_leaves = tree_leaves(grads), tree_leaves(params)
        new_state = {}
        for group, idx in self.groups.items():
            st = state[group]
            if not idx:
                new_state[group] = st
                continue
            dev = g_leaves[idx[0]].device
            # clip_by_global_norm over this group's leaves only
            g_norm = global_norm([g_leaves[i] for i in idx])
            clip = not bool(g_norm < cfg.max_grad_norm)
            count = st.count + 1
            # f32 decay ** count, correctly rounded (as XLA's pow gives it;
            # torch's f32 power is an ulp off for some counts, which
            # 1 - b2 ** count magnifies ~300 times)
            bc1 = 1 - _f32(_as_f32(cfg.adam_b1) ** count, dev)
            bc2 = 1 - _f32(_as_f32(cfg.adam_b2) ** count, dev)
            step = cosine_warmup_schedule(cfg, 1.0, st.count, dev)
            for j, i in enumerate(idx):
                g = g_leaves[i]
                if clip:
                    g = (g / g_norm.to(g.dtype)) * cfg.max_grad_norm
                mu = (1 - cfg.adam_b1) * g + cfg.adam_b1 * st.mu[j]
                nu = (1 - cfg.adam_b2) * (g ** 2) + cfg.adam_b2 * st.nu[j]
                u = (mu / bc1) / (torch.sqrt(nu / bc2) + cfg.adam_eps)
                if self.decay[i]:
                    u = u + cfg.weight_decay * p_leaves[i]
                u = (u * step) * -self.lr[group]
                if not self.trainable[i]:
                    u = torch.zeros_like(u)          # masked(set_to_zero)
                st.mu[j].copy_(mu.to(torch.float32))
                st.nu[j].copy_(nu)
                g_leaves[i].copy_(u)
            new_state[group] = AdamWState(count, st.mu, st.nu)
        return grads, new_state


def build_optimizer(params: Params, cfg: OptimConfig) -> AdamW:
    """Multi-LR AdamW with decay masking, warmup-cosine, per-group grad
    clipping, and freezing of non-tunable modules."""
    return AdamW(params, cfg)


class MultiStepsState(NamedTuple):
    mini_step: int
    gradient_step: int
    inner_opt_state: Any
    acc_grads: List[torch.Tensor]


class MultiSteps:
    """optax ``MultiSteps(opt, k)`` with its default mean: acc <- acc +
    (g - acc) / (mini_step + 1); the first k - 1 mini-steps return zero
    updates, the k-th the inner update of the mean, after which the
    accumulator is zeroed."""

    def __init__(self, opt: AdamW, every_k_schedule: int):
        self.inner = opt
        self.k = every_k_schedule

    def init(self, params: Params) -> MultiStepsState:
        return MultiStepsState(
            0, 0, self.inner.init(params),
            [torch.zeros_like(x) for x in tree_leaves(params)])

    def update(self, grads: Params, state: MultiStepsState, params: Params
               ) -> Tuple[Params, MultiStepsState]:
        g_leaves = tree_leaves(grads)
        for acc, g in zip(state.acc_grads, g_leaves):
            acc.copy_(acc + (g - acc) / (state.mini_step + 1))
        emit = state.mini_step == self.k - 1
        if not emit:
            for g in g_leaves:
                g.zero_()
            return grads, state._replace(mini_step=state.mini_step + 1)
        for g, acc in zip(g_leaves, state.acc_grads):
            g.copy_(acc)
            acc.zero_()
        updates, inner = self.inner.update(grads, state.inner_opt_state,
                                           params)
        return updates, MultiStepsState(0, state.gradient_step + 1, inner,
                                        state.acc_grads)


def apply_updates(params: Params, updates: Params) -> Params:
    """params + updates, in place (optax.apply_updates)."""
    with torch.no_grad():
        for p, u in zip(tree_leaves(params), tree_leaves(updates)):
            p.add_(u.to(p.dtype))
    return params
