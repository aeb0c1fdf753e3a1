"""The port's optimizer (``video3d_tpu_torch/train/optim.py``) against the
JAX package's optax chain: the same numpy parameter and gradient trees
through both for 5 updates, params within 1e-6 relative. Covers the
per-group gradient clip (one group's norm above ``max_grad_norm``, another
below), a frozen prefix (``tunable_prefixes``), weight decay on the decay
mask, the warmup-cosine schedule (learning rate 0 at the first update) and
``MultiSteps``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from video3d_tpu.train import optim as joptim
from video3d_tpu_torch.train import optim as toptim

torch.set_num_threads(1)

SHAPES = {"llm": {"layers": [{"wq": (6, 4), "bq": (4,)},
                             {"wq": (6, 4), "bq": (4,)}],
                  "norm": (6,), "lm_head": (6, 9)},
          "vision": {"w": (5, 3), "b": (3,)},
          "projector": {"w1": (3, 6), "b1": (6,)},
          "image_newline": (6,)}
# gradient scale per top-level module: the llm group's norm exceeds
# max_grad_norm (clipped), the projector group's stays below (not clipped)
GRAD_SCALE = {"llm": 3.0, "vision": 0.2, "projector": 0.05,
              "image_newline": 0.05}


def _tree(shapes, rng, scale=1.0):
    if isinstance(shapes, dict):
        return {k: _tree(v, rng, scale.get(k, 1.0) if isinstance(scale, dict)
                         else scale) for k, v in shapes.items()}
    if isinstance(shapes, list):
        return [_tree(v, rng, scale) for v in shapes]
    return (scale * rng.normal(size=shapes)).astype(np.float32)


def _to_torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _group_norms(grads):
    sq = {"base": 0.0, "vision": 0.0, "projector": 0.0}
    for path, g in toptim.tree_leaves_with_path(grads):
        sq[toptim._module_of(path)] += float((np.asarray(g) ** 2).sum())
    return {k: v ** 0.5 for k, v in sq.items()}


@pytest.mark.parametrize("k_steps", [1, 2])
def test_matches_optax_chain(k_steps):
    cfg_kw = dict(learning_rate=1e-2, mm_vision_tower_lr=3e-3,
                  mm_projector_lr=5e-2, weight_decay=0.1, warmup_ratio=0.25,
                  total_steps=8, max_grad_norm=1.0,
                  tunable_prefixes=("llm", "projector", "image_newline"))
    rng = np.random.default_rng(k_steps)
    params = _tree(SHAPES, rng)
    jparams = jax.tree.map(jnp.asarray, params)
    tparams = _to_torch(params)
    jtx = joptim.build_optimizer(jparams, joptim.OptimConfig(**cfg_kw))
    ttx = toptim.build_optimizer(tparams, toptim.OptimConfig(**cfg_kw))
    if k_steps > 1:
        jtx = optax.MultiSteps(jtx, k_steps)
        ttx = toptim.MultiSteps(ttx, k_steps)
    jstate, tstate = jtx.init(jparams), ttx.init(tparams)
    frozen0 = tparams["vision"]["w"].clone()
    for step in range(5):
        grads = _tree(SHAPES, rng, GRAD_SCALE)
        norms = _group_norms(grads)
        assert norms["base"] > 1.0 > norms["projector"]
        jup, jstate = jtx.update(jax.tree.map(jnp.asarray, grads), jstate,
                                 jparams)
        jparams = optax.apply_updates(jparams, jup)
        before = [p.clone() for p in toptim.tree_leaves(tparams)]
        tup, tstate = ttx.update(_to_torch(grads), tstate, tparams)
        tparams = toptim.apply_updates(tparams, tup)
        for (path, got), want in zip(toptim.tree_leaves_with_path(tparams),
                                     jax.tree.leaves(jparams)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-7, err_msg=path)
        moved = any(not torch.equal(a, b) for a, b in
                    zip(before, toptim.tree_leaves(tparams)))
        # learning rate 0 at the first update; MultiSteps emits on every
        # k-th mini-step only
        assert moved == (step // k_steps >= 1 and step % k_steps
                         == k_steps - 1), step
    assert torch.equal(tparams["vision"]["w"], frozen0)     # frozen prefix


def test_group_clip_is_per_group():
    """Each group is clipped by its own norm: scaling the projector group's
    gradients does not change the llm group's update (a single global clip
    would)."""
    rng = np.random.default_rng(3)
    params = _tree(SHAPES, rng)
    grads = _tree(SHAPES, rng, GRAD_SCALE)
    cfg = toptim.OptimConfig(learning_rate=1e-2, warmup_ratio=0.0,
                             total_steps=8, mm_vision_tower_lr=None)
    outs = []
    for proj_scale in (1.0, 40.0):
        g = jax.tree.map(np.copy, grads)
        g["projector"] = jax.tree.map(lambda a: a * proj_scale,
                                      g["projector"])
        tp = _to_torch(params)
        tx = toptim.build_optimizer(tp, cfg)
        # two updates: the first has learning rate 0
        st = tx.init(tp)
        for _ in range(2):
            up, st = tx.update(_to_torch(g), st, tp)
            tp = toptim.apply_updates(tp, up)
        outs.append(tp)
    assert torch.equal(outs[0]["llm"]["lm_head"], outs[1]["llm"]["lm_head"])
    assert not torch.equal(outs[0]["projector"]["w1"],
                           outs[1]["projector"]["w1"])


def test_schedule_matches_optax():
    cfg = toptim.OptimConfig(total_steps=40, warmup_ratio=0.1)
    jcfg = joptim.OptimConfig(total_steps=40, warmup_ratio=0.1)
    sched = joptim.cosine_warmup_schedule(jcfg, 1.0)
    for count in (0, 1, 3, 4, 5, 20, 39, 40, 50):
        got = float(toptim.cosine_warmup_schedule(cfg, 1.0, count))
        np.testing.assert_allclose(got, float(sched(jnp.int32(count))),
                                   rtol=1e-6, atol=1e-8)
    assert float(toptim.cosine_warmup_schedule(cfg, 1.0, 0)) == 0.0


def test_labels_and_masks_match_jax():
    rng = np.random.default_rng(4)
    params = _tree(SHAPES, rng)
    tx = toptim.build_optimizer(_to_torch(params), toptim.OptimConfig())
    paths = [p for p, _ in toptim.tree_leaves_with_path(params)]
    jpaths = [joptim._path_str(p) for p, _ in
              jax.tree_util.tree_flatten_with_path(params)[0]]
    assert paths == jpaths
    want = [not joptim._no_decay(p, x) for p, x in
            zip(jpaths, jax.tree.leaves(params))]
    assert tx.decay == want
    labels = {g: [jpaths[i] for i in idx] for g, idx in tx.groups.items()}
    assert labels["vision"] == ["vision/b", "vision/w"]
    assert labels["projector"] == ["image_newline", "projector/b1",
                                   "projector/w1"]
