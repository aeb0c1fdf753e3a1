"""The port's grounding path (ScanRefer / Multi3DRefer) against the JAX
package's on the CPU, at ``ModelConfig.tiny()`` in float32 with the JAX
init's weights carried across by ``from_jax_params``: object patch masks
(chunked and unchunked), object features, the three ground heads, the
grounding forwards and ``ground_suffix``, the engine (``ground`` with the
prefix cache off and on, ``ground_batch``, the object-feature cache), the
drivers' jsonl records, and the zero-padded frames of the full-coordinate
route."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from video3d_tpu.config import (DataConfig, FrameSampling, GroundHeadType,
                                ModelConfig, ObjectFeatureType)
from video3d_tpu.constants import IMAGE_TOKEN_INDEX
from video3d_tpu.data.image_processor import SigLipImageProcessor
from video3d_tpu.data.video_processor import VideoProcessor
from video3d_tpu.eval import drivers as jdrv
from video3d_tpu.models import generate as jgen
from video3d_tpu.models import llava_video3d as jlv
from video3d_tpu.models import qwen2 as jqwen
from video3d_tpu.models.splice import (build_splice_plan, slice_suffix_plan,
                                       vision_end)
from video3d_tpu_torch.data.image_processor import \
    SigLipImageProcessor as TSigLipImageProcessor
from video3d_tpu_torch.data.video_processor import \
    VideoProcessor as TVideoProcessor
from video3d_tpu_torch.eval import drivers as tdrv
from video3d_tpu_torch.models import generate as tgen
from video3d_tpu_torch.models import llava_video3d as tlv
from video3d_tpu_torch.models import qwen2 as tqwen
from video3d_tpu_torch.params import _convert, from_jax_params, init_model

from fixtures import FakeTokenizer, make_fake_scene
from port_configs import port_config

torch.set_num_threads(1)

CFG = ModelConfig.tiny()
TCFG = port_config(CFG)
ATOL = 1e-4
HEADS = [GroundHeadType.INFONCE, GroundHeadType.MLP, GroundHeadType.SCORE]
ORIGIN_BOX = [0.0, 0.0, 0.0, 1.0, 1.0, 1.0]


def close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=0,
                               atol=atol)


# ---------------------------------------------------------------------------
# model functions
# ---------------------------------------------------------------------------

def _coords_and_boxes(seed, V=2, H=56, N=7):
    """Pixel coordinates in [-1, 1]^3 and boxes of varied sizes around the
    middle, so masks hold both values; frame V-1 all zeros (a pad frame)
    and box 0 around the origin."""
    rng = np.random.default_rng(seed)
    wc = rng.uniform(-1, 1, (V, H, H, 3)).astype(np.float32)
    wc[-1] = 0.0
    boxes = np.concatenate([rng.uniform(-0.5, 0.5, (N, 3)),
                            rng.uniform(0.5, 2.5, (N, 3))], 1) \
        .astype(np.float32)
    boxes[0] = ORIGIN_BOX
    return wc, boxes


@pytest.mark.parametrize("chunk", [0, 2, 3, None])
@pytest.mark.parametrize("kind", [ObjectFeatureType.PATCH14,
                                  ObjectFeatureType.PATCH27])
def test_object_patch_masks_chunked_match_jax(monkeypatch, kind, chunk):
    """Chunks of at most ``chunk`` objects' comparisons (0: a bound below
    one object's, which still takes one a chunk; None: the default, all 7
    here) give JAX's one broadcast, bit for bit."""
    wc, boxes = _coords_and_boxes(0)
    kw = dict(side=4, patch_px=14, grid=2, pool_px=28)
    want = np.asarray(jlv.object_patch_masks(jnp.asarray(wc),
                                             jnp.asarray(boxes), kind, **kw))
    assert want.any() and not want.all()
    assert want[0, -1].all()           # the pad frame lies in the origin box
    if chunk is not None:
        monkeypatch.setattr(tlv, "MASK_CHUNK_ELEMENTS",
                            max(1, chunk * wc[..., 0].size * 3))
    got = tlv.object_patch_masks(torch.from_numpy(wc),
                                 torch.from_numpy(boxes),
                                 tlv.ObjectFeatureType(kind.value), **kw)
    np.testing.assert_array_equal(got.numpy(), want)


def test_object_features_match_jax():
    rng = np.random.default_rng(2)
    feats = rng.normal(size=(2, 16, 24)).astype(np.float32)
    masks = rng.random((5, 2, 16)) < 0.3
    masks[3] = False                   # no patch: zero feature, not valid
    jf, jv = jlv.object_features_from_masks(jnp.asarray(feats),
                                            jnp.asarray(masks))
    tf, tv = tlv.object_features_from_masks(torch.from_numpy(feats),
                                            torch.from_numpy(masks))
    close(tf, jf, 1e-5)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert not tf[3].any()


def _head_cfgs(head):
    cfg = dataclasses.replace(CFG, ground_head=head)
    return cfg, port_config(cfg)


@pytest.mark.parametrize("head", HEADS)
def test_ground_scores_match_jax(head):
    """All three heads at 1e-5; padded objects at -inf in both."""
    cfg, tcfg = _head_cfgs(head)
    D = CFG.llm.hidden_size
    jp = {"ground_head": jlv.init_ground_head(jax.random.PRNGKey(3), D,
                                              jnp.float32, head)}
    tp = {"ground_head": _convert(jax.tree.map(np.asarray, jp["ground_head"]),
                                  "cpu", None)}
    rng = np.random.default_rng(4)
    q = rng.normal(size=(D,)).astype(np.float32)
    f = rng.normal(size=(6, D)).astype(np.float32)
    valid = np.array([1, 1, 0, 1, 0, 1], bool)
    want = np.asarray(jlv.ground_scores(jp, jnp.asarray(q), jnp.asarray(f),
                                        jnp.asarray(valid), cfg))
    got = tlv.ground_scores(tp, torch.from_numpy(q), torch.from_numpy(f),
                            torch.from_numpy(valid), tcfg).numpy()
    assert got.shape == want.shape == (7 if head == HEADS[0] else 6,)
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    assert np.isneginf(got).sum() == 2
    fin = np.isfinite(want)
    close(got[fin], want[fin], 1e-5)


@pytest.mark.parametrize("head", HEADS)
def test_init_ground_head_shapes_match_jax(head):
    """The port's init draws JAX's shapes; ``init_model`` builds the head
    last (the other weights stay the draws they were) and keeps it in the
    compute dtype under int8 weights; NONE builds none."""
    D = CFG.llm.hidden_size
    want = jax.tree.map(lambda x: x.shape, jlv.init_ground_head(
        jax.random.PRNGKey(0), D, jnp.float32, head))
    got = tlv.init_ground_head(D, "cpu", torch.Generator().manual_seed(0),
                               torch.float32, tlv.GroundHeadType(head.value))
    assert jax.tree.map(lambda x: tuple(x.shape), got) == want
    _, tcfg = _head_cfgs(head)
    with_head = init_model(tcfg, "cpu", torch.Generator().manual_seed(1),
                           bits=8)
    assert all(t.dtype == torch.bfloat16 for t in
               jax.tree.leaves(with_head["ground_head"]))
    _, none_cfg = _head_cfgs(GroundHeadType.NONE)
    without = init_model(none_cfg, "cpu", torch.Generator().manual_seed(1),
                         bits=8)
    assert "ground_head" not in without
    assert torch.equal(without["llm"]["lm_head"]["q"],
                       with_head["llm"]["lm_head"]["q"])


def test_from_jax_params_carries_the_ground_head():
    tree = jax.tree.map(np.asarray, jlv.init_model(jax.random.PRNGKey(0),
                                                   CFG))
    tp = from_jax_params(tree, TCFG, device="cpu")
    for path, leaf in jax.tree_util.tree_leaves_with_path(
            tree["ground_head"]):
        node = tp["ground_head"]
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node.numpy(), leaf)


@pytest.fixture(scope="module")
def model():
    params = jlv.init_model(jax.random.PRNGKey(1), CFG)
    return params, from_jax_params(jax.tree.map(np.asarray, params), TCFG,
                                   device="cpu")


def _model_inputs(B, seed=5, V=2, N=5, prompt=(4, 6)):
    """Random frames, coordinates, voxel ids and proposals for B rows, and
    the splice plan of prompts whose last real token is the <ground>
    label."""
    rng = np.random.default_rng(seed)
    S = CFG.vision.image_size
    g = -(-CFG.vision.num_patches_per_side // CFG.spatial_pool_stride)
    ids_list, labels_list = [], []
    for b in range(B):
        ids = list(rng.integers(310, 400, prompt[0])) + [IMAGE_TOKEN_INDEX] \
            + list(rng.integers(310, 400, prompt[1] + b)) + [301]
        ids_list.append(ids)
        labels_list.append([-100] * (len(ids) - 1) + [301])
    plan = build_splice_plan(ids_list, labels_list, [V] * B,
                             tokens_per_frame=CFG.tokens_per_frame,
                             max_len=48, grid_side=g)
    images = rng.normal(size=(B, V, 3, S, S)).astype(np.float32)
    patch = rng.integers(0, 301, (B, V, g, g, 3)).astype(np.float32)
    wc = np.stack([_coords_and_boxes(seed + b, V=V, N=N)[0]
                   for b in range(B)])
    boxes = np.stack([_coords_and_boxes(seed + b, V=V, N=N)[1]
                      for b in range(B)])
    valid = np.ones((B, N), bool)
    valid[:, -1] = False
    slots = [int(np.nonzero(plan.labels[b] == 301)[0][0]) for b in range(B)]
    return plan, images, patch, wc, boxes, valid, slots


def _batches(plan, images=None, patch=None):
    j = jlv.Batch(
        images=None if images is None else jnp.asarray(images),
        patch_coords=None if patch is None else jnp.asarray(patch),
        text_ids=jnp.asarray(plan.text_ids), kind=jnp.asarray(plan.kind),
        vision_index=jnp.asarray(plan.vision_index),
        labels=jnp.asarray(plan.labels),
        position_ids=jnp.asarray(plan.position_ids),
        mrope_position_ids=jnp.asarray(plan.mrope_position_ids),
        seq_len=jnp.asarray(plan.seq_len))

    def t(a):
        return torch.from_numpy(np.asarray(a)).long()

    p = tlv.Batch(
        images=None if images is None else torch.from_numpy(images),
        patch_coords=None if patch is None else torch.from_numpy(patch),
        text_ids=t(plan.text_ids), kind=t(plan.kind),
        vision_index=t(plan.vision_index),
        position_ids=t(plan.position_ids), seq_len=t(plan.seq_len))
    return j, p


@pytest.mark.parametrize("form", ["forward", "cached", "batch",
                                  "suffix_b1", "suffix_b2"])
def test_grounding_forwards_match_jax(model, form):
    """grounding_forward (B=1), grounding_forward_cached (scores, object
    features, the cache's K/V), grounding_forward_batch (B=2) and
    ground_suffix over a prefix (B=1, and B=2 rows scored at their own
    slots against shared features) against JAX at 1e-4."""
    jp, tp = model
    B = 2 if form in ("batch", "suffix_b2") else 1
    plan, images, patch, wc, boxes, valid, slots = _model_inputs(B)
    jb, tb = _batches(plan, images, patch)
    T = torch.from_numpy
    if form == "forward":
        want = jlv.grounding_forward(jp, CFG, jb, jnp.asarray(wc[0]),
                                     jnp.asarray(boxes[0]),
                                     jnp.asarray(valid[0]),
                                     jnp.asarray(slots[0]))
        got = tlv.grounding_forward(tp, TCFG, tb, T(wc[0]), T(boxes[0]),
                                    T(valid[0]), slots[0])
    elif form == "cached":
        want, jcache, jfeats = jlv.grounding_forward_cached(
            jp, CFG, jb, jnp.asarray(wc[0]), jnp.asarray(boxes[0]),
            jnp.asarray(valid[0]), jnp.asarray(slots[0]), max_cache_len=56,
            cache_dtype=jnp.float32)
        got, tcache, tfeats = tlv.grounding_forward_cached(
            tp, TCFG, tb, T(wc[0]), T(boxes[0]), T(valid[0]), slots[0], 56,
            torch.float32)
        close(tfeats, jfeats, ATOL)
        n = int(plan.seq_len[0])
        close(tcache.k[:, :, :n], np.asarray(jcache.k)[:, :, :n], ATOL)
        close(tcache.v[:, :, :n], np.asarray(jcache.v)[:, :, :n], ATOL)
    elif form == "batch":
        want = jlv.grounding_forward_batch(
            jp, CFG, jb, jnp.asarray(wc), jnp.asarray(boxes),
            jnp.asarray(valid), jnp.asarray(slots, jnp.int32))
        got = tlv.grounding_forward_batch(tp, TCFG, tb, T(wc), T(boxes),
                                          T(valid), slots)
    else:
        # the prefix: a B=1 cached prefill of row 0's plan, cut at the end
        # of the vision block; the suffix plan of B rows sharing it
        jb1, tb1 = _batches(_model_inputs(1)[0], images[:1], patch[:1])
        _, jcache, jfeats = jlv.grounding_forward_cached(
            jp, CFG, jb1, jnp.asarray(wc[0]), jnp.asarray(boxes[0]),
            jnp.asarray(valid[0]), jnp.asarray(slots[0]), max_cache_len=48,
            cache_dtype=jnp.float32)
        P = vision_end(plan)
        suf = slice_suffix_plan(plan, P, 16)
        jsb, tsb = _batches(suf)
        jpre = jqwen.KVCache(jcache.k[:, :, :P], jcache.v[:, :, :P])
        tpre = tqwen.KVCache(T(np.array(jpre.k)), T(np.array(jpre.v)))
        gslot = slots[0] if B == 1 else slots
        want = jgen.ground_suffix(
            jp, CFG, jsb, jpre, prefix_len=P, max_cache_len=P + 16,
            cache_dtype=jnp.float32, obj_feats=jfeats,
            object_valid=jnp.asarray(valid[0]),
            ground_slot=jnp.asarray(gslot, jnp.int32))
        got = tgen.ground_suffix(tp, TCFG, tsb, tpre, P, P + 16,
                                 torch.float32, T(np.array(jfeats)),
                                 T(valid[0]), gslot)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isneginf(got.numpy()),
                                  np.isneginf(want))
    fin = np.isfinite(want)
    close(got.numpy()[fin], want[fin], ATOL)


# ---------------------------------------------------------------------------
# the engine and the drivers
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """Two 3-frame scenes, and a 2-frame one whose first proposal is a box
    around the origin (V < max_frames)."""
    root = str(tmp_path_factory.mktemp("data"))
    infos = [make_fake_scene(root, scene_id=f"scene{i:04d}_00", n_frames=n,
                             extend=i > 0, seed=i)
             for i, n in enumerate((3, 3, 2))]
    for split, kind in (("train", "gt"), ("val", "pred")):
        path = os.path.join(root, "metadata",
                            f"scannet_{split}_{kind}_box.json")
        with open(path) as f:
            boxes = json.load(f)
        boxes[infos[2]["sample_idx"]].insert(0, ORIGIN_BOX)
        with open(path, "w") as f:
            json.dump(boxes, f)
    data_cfg = DataConfig(video_folder=root,
                          annotation_dir=os.path.join(root, "embodiedscan"),
                          metadata_dir=os.path.join(root, "metadata"),
                          frames_upbound=3)
    return infos, data_cfg, jlv.init_model(jax.random.PRNGKey(0), CFG)


def _ecfg(module, tok, **kw):
    kw.setdefault("max_frames", 3)
    return module.EngineConfig(
        max_new_tokens=4, eos_token_id=tok.eos_token_id, buckets=(256,),
        stop_str="", suffix_buckets=(32, 64),
        ground_token_id=tok.vocab["<ground>"], max_objects=8, **kw)


def _engines(scene, frame_sampling=FrameSampling.UNIFORM, **kw):
    _, data_cfg, params = scene
    data_cfg = dataclasses.replace(data_cfg, frame_sampling=frame_sampling)
    ttok, jtok = FakeTokenizer(), FakeTokenizer()
    tp = from_jax_params(jax.tree.map(np.asarray, params), TCFG,
                         device="cpu")
    te = tdrv.InferenceEngine(
        tp, TCFG, ttok, TVideoProcessor(port_config(data_cfg)),
        TSigLipImageProcessor(size=(CFG.vision.image_size,) * 2),
        _ecfg(tdrv, ttok, **kw), device="cpu")
    je = jdrv.InferenceEngine(
        params, CFG, jtok, VideoProcessor(data_cfg),
        SigLipImageProcessor(size=(CFG.vision.image_size,) * 2),
        _ecfg(jdrv, jtok, **kw), device_geometry=True)
    return te, je


def _query(info, i, text=None, dataset="scanrefer"):
    oid = i % 3
    return {
        "id": f"g{i}", "video": info["sample_idx"],
        "box": info["boxes"][oid].tolist(),
        "conversations": [
            {"from": "human",
             "value": f"<image>\n{text or f'find object number {i}'}"},
            {"from": "gpt", "value": "<ground>"}],
        "metadata": {"dataset": dataset, "question_type": "unique",
                     "object_id": oid,
                     "gt_box": info["boxes"][oid].tolist()}}


def _same_results(got, want):
    for (st, ot), (sj, oj) in zip(got, want):
        np.testing.assert_array_equal(ot, oj)
        close(st, sj, ATOL)
        assert int(np.argmax(st)) == int(np.argmax(np.asarray(sj)))


@pytest.mark.parametrize("prefix", [0, 2])
def test_ground_matches_jax(scene, prefix):
    """``ground`` over two scenes, the prefix cache off and on (a miss per
    scene, then suffix-only hits over the cached prefix and object
    features): scores, objects, argmax and the cache counts equal JAX's."""
    infos = scene[0]
    te, je = _engines(scene, prefix_cache_scenes=prefix)
    qs = [_query(infos[0], 0), _query(infos[0], 1), _query(infos[1], 2),
          _query(infos[0], 3, "find it")]
    _same_results([te.ground(q) for q in qs], [je.ground(q) for q in qs])
    assert te.prefix_cache_stats == je.prefix_cache_stats \
        == ([2, 2] if prefix else [0, 0])


def test_ground_batch_matches_jax(scene):
    infos = scene[0]
    te, je = _engines(scene)
    qs = [_query(infos[0], 0), _query(infos[1], 1),
          _query(infos[0], 2, "which one is the tall object")]
    _same_results(te.ground_batch(qs), je.ground_batch(qs))


def test_padded_frames_count_towards_origin_boxes(scene):
    """A 2-frame scene at max_frames 3 (max-coverage sampling, which
    takes no frame twice): JAX's full-coordinate route
    zero-pads frames and coordinates, so the pad frame's patches
    (coordinates 0) lie inside the box around the origin and its tower
    features enter that object's mean. The port reproduces it (scores
    equal JAX's); averaging the real frames only gives another feature."""
    infos = scene[0]
    te, je = _engines(scene, FrameSampling.MC, max_frames=3)
    q = _query(infos[2], 0)
    vd, V, images, coords, patch = te._video_arrays_full(q["video"])
    assert V == 2 and coords.shape[1] == 3 and not coords[0, 2].any()
    boxes, valid, objects, n = te._proposals(vd)
    np.testing.assert_array_equal(objects[0], ORIGIN_BOX)
    side = TCFG.vision.num_patches_per_side
    H = coords.shape[-3]
    masks = tlv.object_patch_masks(coords[0], boxes,
                                   TCFG.world_3d.object_feature_type,
                                   side=side, patch_px=H // side)
    assert masks[0, 2].all()
    _same_results([te.ground(q)], [je.ground(q)])
    with torch.inference_mode():
        vt = tlv.encode_video(te.params, TCFG, images, patch)
    padded, _ = tlv.object_features_from_masks(vt.raw[0], masks)
    real, _ = tlv.object_features_from_masks(vt.raw[0, :V], masks[:, :V])
    assert not torch.allclose(padded[0], real[0])


@pytest.mark.parametrize("driver", ["scanrefer", "multi3drefer"])
@pytest.mark.parametrize("batch_size", [1, 2])
def test_grounding_drivers_match_jax(scene, tmp_path, driver, batch_size):
    """run_scanrefer / run_multi3drefer over two scenes with the prefix
    cache on: at batch_size 1 through ``ground`` (misses and hits), at 2
    through one batched forward a chunk; the jsonl records equal JAX's
    (Multi3DRefer's scores to 1e-4)."""
    infos = scene[0]
    qs = [_query(infos[s], i, dataset=driver)
          for i, s in enumerate((0, 0, 1, 0))]
    for q in qs:
        if driver == "multi3drefer":
            q["box"] = [q["box"]]
    te, je = _engines(scene, prefix_cache_scenes=2)
    run = {"scanrefer": (tdrv.run_scanrefer, jdrv.run_scanrefer),
           "multi3drefer": (tdrv.run_multi3drefer,
                            jdrv.run_multi3drefer)}[driver]
    times = run[0](te, qs, str(tmp_path / "t.jsonl"), batch_size=batch_size)
    run[1](je, qs, str(tmp_path / "j.jsonl"), batch_size=batch_size)
    assert len(times) == len(qs)
    assert te.prefix_cache_stats == je.prefix_cache_stats

    def read(name):
        with open(tmp_path / name) as f:
            return [json.loads(line) for line in f]

    got, want = read("t.jsonl"), read("j.jsonl")
    assert len(got) == len(want) == len(qs)
    for g, w in zip(got, want):
        if driver == "multi3drefer":
            close(g.pop("scores"), w.pop("scores"), ATOL)
        assert g == w


def test_object_cache_follows_its_prefix(scene):
    """The object features a hit reads equal those a miss recomputes, bit
    for bit; evicting a scene's prefix drops its features too."""
    infos = scene[0]
    te, _ = _engines(scene, prefix_cache_scenes=1)
    te.ground(_query(infos[0], 0))
    feats = te._ground_obj_cache[infos[0]["sample_idx"]][0]
    again, _ = _engines(scene, prefix_cache_scenes=1)
    again.ground(_query(infos[0], 1))
    assert torch.equal(again._ground_obj_cache[infos[0]["sample_idx"]][0],
                       feats)
    te.ground(_query(infos[0], 2))
    assert te.prefix_cache_stats == [1, 1]
    te.ground(_query(infos[1], 3))
    assert list(te._ground_obj_cache) == list(te._prefix_cache) \
        == [infos[1]["sample_idx"]]
