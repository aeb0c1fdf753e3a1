"""The port's benchmark (``video3d_tpu_torch/bench/``) against the same
compositions of JAX-package functions that the reference ``bench.py`` and
``scripts/bench/flagship32.py`` / ``paged_batcher.py`` time, on the CPU at
the tiny configuration that ``scripts/bench/full_depth.py::_full_cfg``
builds under ``V3D_BENCH_TINY`` (copied here with the JAX classes; the
port's side is ``port_config`` of it), with 2 frames (a 4-frame pool for
``mc-chain``). The JAX parameter tree (float32; its LLM projections and
head ``quantize_tree``'d to int8 for the flagship modes) goes to the port
through ``from_jax_params``. Each mode's scalar must match to 1e-4
relative; decode tokens must be identical. The JSON line's keys and the
entry point's refusal to run without CUDA close the file.
"""

import ast
import dataclasses
import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from video3d_tpu.config import LLMConfig as JLLMConfig
from video3d_tpu.config import ModelConfig as JModelConfig
from video3d_tpu.config import VisionConfig as JVisionConfig
from video3d_tpu.constants import IMAGE_TOKEN_INDEX
from video3d_tpu.kernels.fused_geometry import \
    fused_patch_voxel_coords as jfused
from video3d_tpu.models import generate as jgen
from video3d_tpu.models import llava_video3d as jlv
from video3d_tpu.models import qwen2 as jqwen
from video3d_tpu.models.paged_kv import (PageAllocator, pages_needed,
                                         set_slot_pages)
from video3d_tpu.models.quant import quantize_tree
from video3d_tpu.models.splice import (build_splice_plan, slice_suffix_plan,
                                       vision_end)
from video3d_tpu.ops import geometry as jgeo
from video3d_tpu.ops.mc_select import greedy_select_frames as jgreedy
from video3d_tpu_torch.bench import __main__ as tbench
from video3d_tpu_torch.bench import flagship as tfl
from video3d_tpu_torch.bench import paged_batcher as tpb
from video3d_tpu_torch.config import ModelConfig as TModelConfig
from video3d_tpu_torch.models import generate as tgen
from video3d_tpu_torch.params import from_jax_params

from port_configs import port_config

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JCFG = JModelConfig(
    vision=dataclasses.replace(JVisionConfig(), num_hidden_layers=1),
    llm=dataclasses.replace(JLLMConfig(), num_hidden_layers=4,
                            hidden_size=256, intermediate_size=512,
                            num_attention_heads=4, num_key_value_heads=2,
                            head_dim=64, mrope_section=(16, 8, 8),
                            vocab_size=2048))
TCFG = port_config(JCFG)
V, POOL, PROMPT, CROP = 2, 4, 16, 384
REL = 1e-4


def _close(got, want):
    got, want = float(got), float(want)
    assert abs(got - want) <= REL * max(abs(want), 1e-6), (got, want)


@pytest.fixture(scope="module")
def models():
    tree = jlv.init_model(jax.random.PRNGKey(0), JCFG)
    qtree = quantize_tree(tree)
    port = from_jax_params(jax.tree.map(np.asarray, tree), TCFG,
                           device="cpu")
    qport = from_jax_params(jax.tree.map(np.asarray, qtree), TCFG,
                            device="cpu")
    return tree, qtree, port, qport


@pytest.fixture(scope="module")
def scan():
    return tfl.make_scan(V)


def _jax_geometry(depths, intr, poses):
    """flagship32's composed geometry (unproject, resize, crop, patch mean,
    voxelize)."""
    vox = JCFG.world_3d.voxel
    new_w = int(640 * (CROP / 480))
    wc = jgeo.unproject(intr, poses, depths)
    wc = jgeo.center_crop(jgeo.resize_nearest(wc, (CROP, new_w)),
                          (CROP, CROP))
    return jgeo.discrete_coords(jgeo.average_coordinate_in_patch(wc),
                                vox.min_xyz_range, vox.max_xyz_range,
                                vox.voxel_size)


def _jax_prefill(params, spliceable, L):
    D = spliceable.shape[-1]
    embeds = jnp.zeros((1, L, D), spliceable.dtype)
    embeds = jax.lax.dynamic_update_slice(embeds, spliceable, (0, PROMPT, 0))
    pos = jnp.broadcast_to(jnp.arange(L)[None, :, None], (1, L, 3))
    hidden, _ = jqwen.qwen2_forward(params["llm"], JCFG.llm, embeds, pos)
    return hidden


def test_tiny_config_is_the_jax_scripts():
    assert tfl.full_cfg(tiny=True) == TCFG
    assert tbench.bench_config(tiny=True) == TCFG


def test_chain_flops_equal_the_jax_scripts():
    """``flagship32.chain_flops`` read out of the script (importing it would
    set the process's JAX compilation cache), for ModelConfig()."""
    path = os.path.join(REPO, "scripts", "bench", "flagship32.py")
    tree = ast.parse(open(path).read())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "chain_flops")
    ns = {}
    exec(compile(ast.Module([fn], []), path, "exec"), ns)
    for v, L in ((32, 6784), (8, 1792)):
        assert tfl.chain_flops(TModelConfig(), v, L) \
            == ns["chain_flops"](JModelConfig(), v, L)


def test_steady_and_cold_pipelines_match_jax(models, scan):
    """bench.py's warm (B1 -> finish_video_tokens -> splice -> prefill) and
    cold (B1 -> encode_video -> ...) pipelines at prefill 1792."""
    tree, _, port, _ = models
    depths, intr, poses, images = scan
    g = 14
    vox_cfg = JCFG.world_3d.voxel
    jvox = jfused(jnp.asarray(depths), jnp.asarray(intr), jnp.asarray(poses),
                  crop=CROP, grid=g, min_xyz=vox_cfg.min_xyz_range,
                  max_xyz=vox_cfg.max_xyz_range, voxel=vox_cfg.voxel_size)
    n_vis = V * JCFG.tokens_per_frame
    pooled, raw = jlv.encode_video_pooled(tree, JCFG, jnp.asarray(images))
    vt = jlv.finish_video_tokens(tree, JCFG, pooled, raw, jvox[None])
    want_warm = jnp.sum(_jax_prefill(tree, vt.spliceable, tbench.PREFILL_LEN)
                        [:, PROMPT + n_vis])
    vt = jlv.encode_video(tree, JCFG, jnp.asarray(images), jvox[None])
    want_cold = jnp.sum(_jax_prefill(tree, vt.spliceable, tbench.PREFILL_LEN)
                        [:, PROMPT + n_vis])

    d, i, p, im = tfl.scan_tensors(scan, "cpu")
    tpooled, traw = tbench.pooled_features(port, TCFG, im)
    _close(tbench.warm_scalar(port, TCFG, d, i, p, tpooled, traw), want_warm)
    _close(tbench.cold_scalar(port, TCFG, d, i, p, im), want_cold)


def test_chain_and_stages_match_jax(models, scan):
    _, qtree, _, qport = models
    depths, intr, poses, images = (jnp.asarray(a) for a in scan)
    L = tfl.bucket(PROMPT + V * JCFG.tokens_per_frame)
    n_vis = V * JCFG.tokens_per_frame
    jvox = _jax_geometry(depths, intr, poses)
    jspl = jlv.encode_video(qtree, JCFG, images, jvox[None]).spliceable
    hidden = _jax_prefill(qtree, jspl, L)

    d, i, p, im = tfl.scan_tensors(scan, "cpu")
    _close(tfl.chain_scalar(qport, TCFG, d, i, p, im, L),
           jnp.sum(hidden[:, PROMPT + n_vis]))
    vox = tfl.stage_geometry(TCFG, d, i, p)
    np.testing.assert_array_equal(vox.numpy(), np.asarray(jvox))
    spl = tfl.stage_tower(qport, TCFG, im, vox)
    np.testing.assert_allclose(spl.numpy(), np.asarray(jspl), rtol=REL,
                               atol=REL * float(jnp.abs(jspl).max()))
    _close(tfl.stage_prefill(qport, TCFG, spl, L), jnp.sum(hidden[:, -1]))


@pytest.mark.parametrize("it", [0, 1])
def test_prefix_matches_jax(models, it):
    """start_decode_prefix of a 64-token suffix batch (B=3) over an int8
    prefix with 0.01 scales, next-token logits summed (iteration ``it``)."""
    _, qtree, _, qport = models
    B = 3
    T = JCFG.tokens_per_frame
    L = tfl.bucket(PROMPT + V * T)
    ids = [10] * 15 + [IMAGE_TOKEN_INDEX] + [20] * 30
    plan = build_splice_plan([ids], None, [V], tokens_per_frame=T,
                             max_len=L, grid_side=14)
    P = vision_end(plan)
    suf = slice_suffix_plan(plan, P, 64)

    def tile(x):
        return jnp.asarray(np.broadcast_to(np.asarray(x),
                                           (B,) + np.asarray(x).shape[1:]))

    batch = jlv.Batch(images=None, patch_coords=None,
                      text_ids=tile(suf.text_ids), kind=tile(suf.kind),
                      vision_index=tile(suf.vision_index),
                      labels=tile(suf.labels),
                      position_ids=tile(suf.position_ids),
                      mrope_position_ids=tile(suf.mrope_position_ids),
                      seq_len=tile(suf.seq_len))
    nl, KV, hd = 4, 2, 64
    eps = it * 1e-8
    rows = jnp.arange(B, dtype=jnp.int32)[:, None]
    ids_i = jnp.where(batch.kind == 1, (batch.text_ids + it + rows) % 997
                      + 20, batch.text_ids)
    prefix = jqwen.KVCache(
        jnp.zeros((nl, 1, P, KV * hd), jnp.int8),
        jnp.zeros((nl, 1, P, KV * hd), jnp.int8),
        0.01 * jnp.ones((nl, 1, P, KV, 1), jnp.float32) + eps,
        0.01 * jnp.ones((nl, 1, P, KV, 1), jnp.float32) + eps)
    st = jgen.start_decode_prefix(qtree, JCFG, batch._replace(text_ids=ids_i),
                                  prefix, prefix_len=P, max_cache_len=L + 512,
                                  cache_dtype=jnp.int8)
    want = jnp.sum(st.next_logits.astype(jnp.float32)) * 1e-6

    tb, tprefix, tP, mcl = tfl.prefix_inputs(TCFG, B, "cpu", v_frames=V)
    assert (tP, mcl) == (P, L + 512)
    _close(tfl.prefix_scalar(qport, TCFG, tb, tprefix, tP, mcl, it), want)


# ctx over the int8 cache: K/V are rounded to int8 steps, and f32 rsqrt /
# cos differ by an ulp between XLA and torch, so ~0.15% of the cached K
# values land one step apart (195 of 131,072 on these inputs) and the
# scalar moves by ~4e-4 relative; over an f32 cache the same chunks agree to
# ~2e-7. The int8 form is held to INT8_CACHE_REL, the f32 form to REL.
INT8_CACHE_REL = 5e-3


@pytest.mark.parametrize("form", ["float32", "int8"])
def test_ctx_chunked_prefill_matches_jax(models, form):
    """flagship32's ctx32k at L=256 in chunks of 64 (int8 in the benchmark;
    also over an f32 cache, where the chunk machinery is held to REL)."""
    _, qtree, _, qport = models
    L, chunk = 256, 64
    ids = tfl.ctx_ids(TCFG, L, "cpu")
    llm = qtree["llm"]
    emb = jnp.take(llm["embed_tokens"], jnp.asarray(ids.numpy()), axis=0)[None]
    cache = jqwen.KVCache.zeros(JCFG.llm, 1, L, dtype=getattr(jnp, form))
    kv_len = jnp.full((1,), L, jnp.int32)
    for start in range(0, L, chunk):
        cpos = (start + jnp.arange(chunk))[None]
        hidden, cache = jqwen.qwen2_forward(
            llm, JCFG.llm, emb[:, start:start + chunk],
            jnp.broadcast_to(cpos[..., None], (1, chunk, 3)), kv_cache=cache,
            cache_positions=cpos, kv_len=kv_len, contiguous_update=True)
    got = tfl.ctx_scalar(qport["llm"], TCFG, ids, chunk,
                         cache_dtype=getattr(torch, form))
    want = float(jnp.sum(hidden[:, -1].astype(jnp.float32)))
    rel = REL if form == "float32" else INT8_CACHE_REL
    assert abs(float(got) - want) <= rel * abs(want), (float(got), want)


def test_mc_chain_matches_jax(models):
    """flagship32's mc-chain: exact greedy selection of 2 of a 4-frame pool
    from full-resolution voxels, then the chain over the picks."""
    _, qtree, _, qport = models
    scan = tfl.make_scan(POOL)
    scene = tfl.mc_scene()
    depths, intr, poses, images = (jnp.asarray(a) for a in scan)
    vox_cfg = JCFG.world_3d.voxel
    L = tfl.bucket(PROMPT + V * JCFG.tokens_per_frame)
    wc_full = jgeo.unproject(intr, poses, depths)
    fv = jgeo.discrete_coords(wc_full, vox_cfg.min_xyz_range,
                              vox_cfg.max_xyz_range,
                              vox_cfg.voxel_size).reshape(POOL, -1, 3)
    order, gains, _ = jgreedy(fv, jnp.asarray(scene), max_frames=V)
    wc = jnp.take(wc_full, order, axis=0)
    wc = jgeo.center_crop(jgeo.resize_nearest(wc, (CROP, 512)),
                          (CROP, CROP))
    vox = jgeo.discrete_coords(jgeo.average_coordinate_in_patch(wc),
                               vox_cfg.min_xyz_range, vox_cfg.max_xyz_range,
                               vox_cfg.voxel_size)
    vt = jlv.encode_video(qtree, JCFG, jnp.take(images, order, axis=1),
                          vox[None])
    hidden = _jax_prefill(qtree, vt.spliceable, L)
    want = (jnp.sum(hidden[:, PROMPT + V * JCFG.tokens_per_frame])
            + gains.sum().astype(jnp.float32) * 1e-9)

    d, i, p, im = tfl.scan_tensors(scan, "cpu")
    got, torder = tfl.mc_chain_scalar(qport, TCFG, d, i, p, im,
                                      torch.from_numpy(scene), L, V)
    np.testing.assert_array_equal(torder.numpy(), np.asarray(order))
    _close(got, want)


@pytest.mark.parametrize("mode", ["dense", "paged"])
def test_decode_chunk_tokens_match_jax(models, mode):
    """paged_batcher's slot setup (one long slot, the rest at 512; int8
    cache) and one decode chunk: identical tokens."""
    tree, _, port, _ = models
    S, cache_len, chunk, page = 3, 1024, 4, 64
    lens = tpb.slot_lens(S, cache_len, chunk, 1)
    if mode == "dense":
        st = jgen.empty_decode_state(JCFG, S, cache_len, cache_dtype=jnp.int8)
        st = st._replace(pos=jnp.asarray(lens), done=jnp.zeros((S,), bool),
                         next_logits=jnp.zeros_like(st.next_logits))
        _, want = jgen.decode_chunk(tree, JCFG, st, chunk=chunk,
                                    eos_token_id=-1)
        tst = tpb.dense_state(TCFG, lens, cache_len, torch.int8, "cpu")
        _, got = tgen.decode_chunk(port, TCFG, tst, chunk=chunk,
                                   eos_token_id=-1)
    else:
        max_pages = cache_len // page
        total = 1 + sum(pages_needed(int(n) + chunk + 8, page) for n in lens)
        st = jgen.empty_paged_state(JCFG, S, total, page, max_pages,
                                    cache_dtype=jnp.int8)
        alloc = PageAllocator(total)
        cache = st.cache
        for s in range(S):
            cache = set_slot_pages(cache, s, alloc.alloc(
                pages_needed(int(lens[s]) + chunk + 8, page)))
        st = st._replace(cache=cache._replace(lens=jnp.asarray(lens)),
                         done=jnp.zeros((S,), bool),
                         next_logits=jnp.zeros_like(st.next_logits))
        table = np.asarray(st.cache.page_table)   # the chunk donates st
        _, want = jgen.paged_decode_chunk(tree, JCFG, st, chunk=chunk,
                                          eos_token_id=-1)
        tst, ttotal = tpb.paged_state(TCFG, lens, cache_len, chunk, page,
                                      torch.int8, "cpu")
        assert ttotal == total
        np.testing.assert_array_equal(tst.cache.page_table.numpy(), table)
        _, got = tgen.paged_decode_chunk(port, TCFG, tst, chunk=chunk,
                                         eos_token_id=-1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_paged_batcher_run_reports_its_mix(models):
    _, _, port, _ = models
    res = tpb.run(port, TCFG, "paged", "cpu", slots=3, cache_len=1024,
                  chunk=2, int8=True, page=64)
    assert res["kv_hbm_gib"] < res["dense_rows_gib"]
    assert res["ms_per_step"] > 0 and len(res["last_tokens"]) == 3


def test_bench_line_has_the_reference_keys():
    buf = io.StringIO()
    with redirect_stdout(buf):
        tbench.main(["--device", "cpu", "--tiny", "--iters", "1"])
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    for key in ("metric", "value", "unit", "vs_baseline", "baseline_fps",
                "flagship", "device", "hbm_read_gbps"):
        assert key in line, key
    assert line["unit"] == "frames/s" and line["value"] > 0
    assert set(line["flagship"]["chain32_int8"]) == {
        "frames_per_s", "chain_ms", "prefill_len", "mfu_pct_bf16peak"}
    assert set(line["flagship"]["prefix32_int8_b8"]) == {
        "question_ms", "chunk_ms", "prefix_len", "suffix_bucket"}
    assert line["device"]["name"] == "cpu" and line["hbm_read_gbps"] is None


def test_entry_point_without_cuda_exits_non_zero():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    res = subprocess.run([sys.executable, "-m", "video3d_tpu_torch.bench"],
                         capture_output=True, text=True, timeout=300,
                         env=env, cwd=REPO)
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr
    assert not res.stdout.strip()


@pytest.mark.parametrize("mode,B", [("cold", 1), ("cold", 2),
                                    ("prefix", 2)])
def test_grounding_modes_match_jax(models, mode, B):
    """``bench/grounding.py``'s scalars at iteration 1 against the JAX
    script's loop body on the same inputs: ``grounding_forward`` (B=1) or
    ``grounding_forward_batch``, and ``ground_suffix`` over the int8
    prefix, on the int8 LLM."""
    from video3d_tpu_torch.bench import grounding as tgr

    _, qtree, _, qport = models
    i = 1
    if mode == "cold":
        batch, plan = tgr.plan_batch(TCFG, V, B, "cpu")
        arrays = tgr.scene_arrays(TCFG, V, B, "cpu")
        slot = int(plan.seq_len[0]) - 1
        got = tgr.cold_scalar(qport, TCFG, batch, *arrays, slot, i)
        images, wc, patch, boxes, valid = (jnp.asarray(a.numpy())
                                           for a in arrays)
        kind = jnp.asarray(np.broadcast_to(plan.kind, (B, plan.kind.shape[1])))
        ids = jnp.asarray(np.broadcast_to(plan.text_ids, kind.shape))
        jb = jlv.Batch(
            images=images + i * 1e-6, patch_coords=patch,
            text_ids=jnp.where(kind == 1, (ids + i) % 997 + 20, ids),
            kind=kind, vision_index=jnp.asarray(np.broadcast_to(
                plan.vision_index, kind.shape)),
            labels=None, position_ids=jnp.asarray(np.broadcast_to(
                plan.position_ids, kind.shape)),
            mrope_position_ids=None,
            seq_len=jnp.asarray(np.broadcast_to(plan.seq_len, (B,))))
        if B == 1:
            s = jlv.grounding_forward(qtree, JCFG, jb, wc[0], boxes[0],
                                      valid[0], jnp.asarray(slot))
        else:
            s = jlv.grounding_forward_batch(qtree, JCFG, jb, wc, boxes, valid,
                                            jnp.full((B,), slot, jnp.int32))
    else:
        sbatch, prefix, P, slot, feats, valid = tgr.prefix_inputs(
            TCFG, V, B, "cpu")
        got = tgr.prefix_scalar(qport, TCFG, sbatch, prefix, P, slot, feats,
                                valid, i)
        eps = i * 1e-8
        rows = jnp.arange(B)[:, None]
        kind = jnp.asarray(sbatch.kind.numpy())
        ids = jnp.asarray(sbatch.text_ids.numpy())
        jb = jlv.Batch(
            images=None, patch_coords=None,
            text_ids=jnp.where(kind == 1, (ids + i + rows) % 997 + 20, ids),
            kind=kind, vision_index=jnp.asarray(sbatch.vision_index.numpy()),
            labels=None, position_ids=jnp.asarray(
                sbatch.position_ids.numpy()),
            mrope_position_ids=jnp.asarray(np.broadcast_to(
                sbatch.position_ids.numpy()[..., None], kind.shape + (3,))),
            seq_len=jnp.asarray(sbatch.seq_len.numpy()))
        jpre = jqwen.KVCache(*(jnp.asarray(t.numpy()) for t in prefix[:2]),
                             *(jnp.asarray(t.numpy()) + eps
                               for t in prefix[2:]))
        s = jgen.ground_suffix(
            qtree, JCFG, jb, jpre, prefix_len=P,
            max_cache_len=P + tfl.SUFFIX, cache_dtype=jnp.int8,
            obj_feats=jnp.asarray(feats.numpy()) + eps,
            object_valid=jnp.asarray(valid.numpy()),
            ground_slot=jnp.asarray(slot))
    _close(got, jnp.sum(s.astype(jnp.float32)) * 1e-6)
