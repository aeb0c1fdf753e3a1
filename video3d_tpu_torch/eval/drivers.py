"""Inference drivers of the PyTorch port for the paper's five benchmarks:
counterpart of ``video3d_tpu/eval/drivers.py``.

Generative (ScanQA, SQA3D, Scan2Cap, free-form VQA), per question:
eval-style ChatML ids with an empty assistant turn, the scene's frames and
raw depths, per-patch voxel ids through the fused geometry kernel, the
static splice plan, generation (greedy, sampled or beam search, as the
JAX engine's ``EngineConfig`` says), and one jsonl record, in the same
format as the JAX driver. Scan2Cap adds the ``<coord>`` box input: the
sin3d PE of the object's discretized center at the ``<coord>`` slot.

Discriminative (ScanRefer, Multi3DRefer), per query: training-style ChatML
ids with the ``<ground>`` answer, the frames and full per-pixel world
coordinates (host geometry, zero-padded to ``max_frames`` as in JAX), the
grounding forward (object patch masks, masked-mean object features, the
hidden state at ``<ground>``, the ground head), and one jsonl record.

Two scene-level caches, as in the JAX engine (every question on a scene
shares its frames and its spliced prefix):

* ``EngineConfig.scene_cache_scenes``: an LRU of the scenes' spliceable
  vision features, so a hit skips video IO, geometry and the tower;
* ``EngineConfig.prefix_cache_scenes``: an LRU of the scenes' prefix KV
  (system + user header + vision block). The first question of a scene
  runs the full prefill and stores the prefix; later questions prefill only
  their suffix against it (``start_decode_prefix``), alone (B = 1) or as a
  scene-grouped batch (``generate_answers_batch_prefix``,
  ``run_generative(..., batch_size=B)``). As in JAX, beam search
  (``num_beams > 1``) bypasses it: every answer is a full prefill. Grounding keeps a companion LRU
  of each scene's object features beside its prefix entry, so a hit
  prefills only the query suffix (``ground_suffix``).

Entry points outside the 3D scenes (JAX's legacy modalities): a real
video file (``generate_answer_video_file``: frames sampled with the decord
contract, no world PE), a 2D image (``generate_answer_image``: the
``pad``, ``anyres``, ``highres`` and ``crop_split`` tilings with the
``flat``, ``spatial`` and ``spatial_unpad`` merges) and several 2D images
in one chat (``generate_answer_images``: each at its own ``<image>``
sentinel, its full unpooled grid).

The serving entry points (``serve/model_worker.py``): multi-turn records
(every turn through ``preprocess_qwen_eval``), ``generate_answer_stream``
(the cumulative text after every chunk of decode steps, one prefill) and
per-call budgets and sampling settings. Streams and per-call overrides
decode eagerly, in host-driven chunks: a captured entry's static state is
shared by every caller of its shapes, and a generator may not hold the
holder's lock across a ``yield``; ``generate_answer`` keeps its captured
decode.

Host code (tokenization, frame IO, image preprocessing, splice planning) is
the port's own copy of the JAX package's (``video3d_tpu_torch/data``,
``models/splice.py``): the port imports nothing of ``video3d_tpu``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from threading import Lock
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from video3d_tpu_torch.config import ModelConfig, PosEmbedType
from video3d_tpu_torch.constants import DEFAULT_IMAGE_TOKEN, IMAGE_TOKEN_INDEX
from video3d_tpu_torch.data.image_processor import SigLipImageProcessor
from video3d_tpu_torch.data.tokenization import (preprocess_qwen,
                                                 preprocess_qwen_eval)
from video3d_tpu_torch.data.video_processor import VideoProcessor
from video3d_tpu_torch.kernels.fused_geometry import fused_patch_voxel_coords
from video3d_tpu_torch.models import llava_video3d as lv3d
from video3d_tpu_torch.models import qwen2
from video3d_tpu_torch.models.beam_search import generate_beam
from video3d_tpu_torch.models.decode_graph import DecodeGraphs
from video3d_tpu_torch.models import speculative as spec
from video3d_tpu_torch.models.generate import (ChunkedPrefill, DecodeState,
                                               GenerateResult, decode_chunk,
                                               generate_from_state,
                                               generate_greedy, ground_suffix,
                                               start_decode,
                                               start_decode_prefix)
from video3d_tpu_torch.models.splice import (KIND_VISION, build_splice_plan,
                                             slice_suffix_plan,
                                             vision_end_from_kind)
from video3d_tpu_torch.ops import geometry
from video3d_tpu_torch.ops.voxel_dedup import default_order_keys
from video3d_tpu_torch.params import (check_card_path, check_config,
                                      resolve_device)

DEFAULT_BUCKETS = (1024, 2048, 4096, 8192, 16384)


def pick_bucket(n: int, buckets: Sequence[int] = DEFAULT_BUCKETS) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


@dataclass
class EngineConfig:
    """Generation settings of the answer path."""

    max_new_tokens: int = 512
    eos_token_id: int = 151645          # <|im_end|>
    max_frames: int = 32
    buckets: Tuple[int, ...] = DEFAULT_BUCKETS
    stop_str: str = "<|im_end|>"
    # prepended to the question text (the JAX engine's ``extra_prompt``;
    # reference-parity eval keeps it "")
    extra_prompt: str = ""
    # LRU of N scenes' spliceable vision features (0 = off)
    scene_cache_scenes: int = 0
    # LRU of N scenes' prefix KV (0 = off); device memory per scene:
    # prefix_len * layers * 2 * KV * hd * 2 bytes with a bf16 cache (~0.39
    # GB at 7B, 6.7k), with an int8 one prefix_len * layers * 2 * KV *
    # (hd + 4) bytes (values and f32 scales, ~0.20 GB), with an int4 one
    # prefix_len * layers * 2 * KV * (hd / 2 + 4) bytes (~0.10 GB)
    prefix_cache_scenes: int = 0
    # suffix prefill buckets of the prefix path
    suffix_buckets: Tuple[int, ...] = (64, 128, 256, 512)
    # KV cache storage: "bfloat16", "int8" (values plus f32 scales per
    # token and kv head; halves the cache's bytes) or "int4" (values packed
    # two per byte, the same scales; halves them again)
    kv_cache_dtype: str = "bfloat16"
    # grounding: the <ground> token's id (its hidden state is the query)
    # and the proposals scored per scene (more are dropped, fewer padded)
    ground_token_id: Optional[int] = None
    max_objects: int = 150
    # sampling (reference generate kwargs, model_scanqa.py:176-180:
    # do_sample = temperature > 0); 0.0 -> greedy, the eval default
    temperature: float = 0.0
    top_p: float = 1.0
    top_k: int = 0
    # beam search (model_scanqa.py:230 --num_beams; 1 = greedy / sampled)
    num_beams: int = 1
    length_penalty: float = 1.0
    early_stopping: bool = False
    # speculative decoding (models/speculative.py): draft layers > 0 turns
    # on an early-exit self-draft of that many target layers (or attach a
    # draft with InferenceEngine.set_draft_model); greedy answers are
    # unchanged, sampled ones follow the same warped target distribution
    speculative_draft_layers: int = 0
    speculative_k: int = 4
    # the self-draft's lm_head cut to its first N token columns (0: all)
    speculative_draft_vocab: int = 0
    # > 0: below this measured acceptance (after a few requests) fall back
    # to plain decoding
    speculative_min_acceptance: float = 0.0

    def sampling(self) -> dict:
        """The decode loops' sampling keywords."""
        return {"temperature": self.temperature, "top_p": self.top_p,
                "top_k": self.top_k}

    def cache_dtype(self):
        """The cache form the models take: a torch dtype, or the int4 tag
        ``qwen2.KV_INT4``."""
        dtypes = {"bfloat16": torch.bfloat16, "int8": torch.int8,
                  "int4": qwen2.KV_INT4}
        if self.kv_cache_dtype not in dtypes:
            raise ValueError(f"kv_cache_dtype {self.kv_cache_dtype!r}: "
                             f"expected one of {sorted(dtypes)}")
        return dtypes[self.kv_cache_dtype]


class _PrefixEntry(NamedTuple):
    """Scene-prefix KV cache entry (EngineConfig.prefix_cache_scenes)."""

    cache: qwen2.KVCache   # (layers, 1, P, ...) k/v[/scales], entry-owned
    prefix_len: int        # P: spliced index one past the vision block
    num_frames: int        # V used when the prefix was built
    ids_prefix: tuple      # prompt ids up to and including the <image> slot


class InferenceEngine:
    """One model on one device answering ScanQA-style records.

    ``params`` come from :func:`video3d_tpu_torch.params.init_model` or
    :func:`~video3d_tpu_torch.params.from_jax_params` and live on
    ``device`` (default: the first CUDA card; without one the default
    raises, see :func:`~video3d_tpu_torch.params.resolve_device`). With
    ``device_geometry`` (the default, as JAX's off the CPU) the answers'
    voxel ids come from the fused geometry kernel on the raw depths;
    without it from the host geometry of ``process_3d_video``, patch means
    and the clip / round discretization (JAX's host route, the grounding
    route's arrays). Grounding always takes the host route: its masks need
    every pixel's coordinates.
    """

    def __init__(self, params, model_cfg: ModelConfig, tokenizer,
                 video_processor: VideoProcessor,
                 image_processor: Optional[SigLipImageProcessor] = None,
                 engine_cfg: Optional[EngineConfig] = None,
                 device=None, device_geometry: bool = True):
        lv3d.check_projector(model_cfg, params.get("projector"))
        check_config(model_cfg)
        self.device_geometry = bool(device_geometry)
        self.params = params
        self.cfg = model_cfg
        self.tokenizer = tokenizer
        self.vp = video_processor
        self.ip = image_processor or SigLipImageProcessor(
            size=(model_cfg.vision.image_size,) * 2)
        self.ecfg = engine_cfg or EngineConfig()
        self.cache_dtype = self.ecfg.cache_dtype()
        self.device = resolve_device(device)
        # a decoder family whose head width has no card form on this
        # engine's paths is refused here, before any work
        check_card_path(model_cfg, self.device, "answer")
        if self.ecfg.prefix_cache_scenes:
            # the batched answers over a cached scene prefix run B5
            check_card_path(model_cfg, self.device, "shared_prefix")
        if self.cache_dtype not in (None, torch.bfloat16, torch.float32):
            check_card_path(model_cfg, self.device, "quantized_cache")
        self.dtype = params["llm"]["embed_tokens"].dtype
        # scene LRUs keyed by video id; the lock guards both (a worker
        # thread prepares the next request while the device runs this one)
        self._cache_lock = Lock()
        self._scene_cache: "OrderedDict" = OrderedDict()   # -> (feats, V)
        self.scene_cache_stats = [0, 0]                      # [hits, misses]
        self._prefix_cache: "OrderedDict" = OrderedDict()  # -> _PrefixEntry
        self.prefix_cache_stats = [0, 0]                     # [hits, misses]
        # grounding's companion LRU: video id -> (object features (N, D),
        # valid (N,), objects (n0, 6) numpy, n), held only while the
        # scene's prefix entry is
        self._ground_obj_cache: "OrderedDict" = OrderedDict()
        # called with each evicted scene key after _cache_lock is released
        # (the paged batcher drops its shared prefix pages on eviction,
        # serve/batcher.py); a hook must not re-enter the engine's caches
        self._prefix_evict_hooks: list = []
        # the captured decode chunks of this engine's answers and the
        # static states they run on (models/decode_graph.py), on the card
        self._graphs = (DecodeGraphs(self.device)
                        if self.device.type == "cuda" else None)
        # speculative decoding: a draft attached by set_draft_model, the
        # cumulative [accepted drafts, draft slots offered], and the
        # min-acceptance guard's switch
        self.draft_params = None
        self.draft_cfg = None
        self.spec_stats = [0, 0]
        self._spec_disabled = False

    def set_draft_model(self, draft_params, draft_cfg) -> None:
        """Attach standalone draft weights (the target's hidden size and
        vocabulary; an ``LLMConfig``) for speculative decoding."""
        self.draft_params = draft_params
        self.draft_cfg = draft_cfg

    # ------------- shared assembly -------------

    def _grid_side(self) -> int:
        mc = self.cfg
        return -(-mc.vision.num_patches_per_side // mc.spatial_pool_stride)

    def _video_arrays_device(self, video_id: str):
        """Frames + voxel ids of the V sampled frames. Unlike the JAX engine,
        which zero-pads to ``max_frames`` for a static shape, only the V real
        frames are kept: the splice plan indexes only their tokens, so the
        tower runs on V frames."""
        mc = self.cfg
        S = mc.vision.image_size
        raw = self.vp.load_raw(video_id, self.ip, force_sample=True,
                               frames_upbound=self.ecfg.max_frames)
        V = raw["video_size"]
        dev = self.device
        vox = mc.world_3d.voxel
        patch = fused_patch_voxel_coords(
            torch.from_numpy(np.ascontiguousarray(raw["depths"][:V],
                                                  np.int32)).to(dev),
            torch.from_numpy(np.asarray(raw["intrinsic"], np.float32)).to(dev),
            torch.from_numpy(np.asarray(raw["poses"][:V], np.float32)).to(dev),
            crop=S, grid=self._grid_side(), min_xyz=vox.min_xyz_range,
            max_xyz=vox.max_xyz_range, voxel=vox.voxel_size,
            discretize=mc.world_3d.discrete)
        images = torch.from_numpy(
            np.ascontiguousarray(raw["images"][:V], np.float32))[None]
        return V, images.to(dev), patch[None]

    def _check_pooling(self) -> None:
        """The engine pools patch coordinates to one point per patch (B1's
        means, or the host route's means). A pooling of n > 1 points
        (MINMAX, SAMPLE9, SAMPLE5) cannot answer: JAX's engine takes its
        host route there, which pools means too, and fails reshaping them
        for the n-point PE. The port refuses it before any work, and so
        the ONE_TOKEN newline layout (``lv3d.check_newline_layout``)."""
        lv3d.check_newline_layout(self.cfg)
        pooling = self.cfg.world_3d.pooling
        if pooling.n_points != 1:
            raise ValueError(
                f"{pooling.value} coordinate pooling ({pooling.n_points} "
                f"points per patch) cannot be answered by the engine, whose "
                f"patch coordinates are one point per patch (the JAX engine "
                f"fails on it too)")

    def _video_arrays(self, video_id: str):
        """(V, images, patch voxel ids) of an answer: B1's on the V real
        frames, or the host route's zero-padded to ``max_frames`` (the
        plan indexes only the V real frames either way)."""
        self._check_pooling()
        if self.device_geometry:
            return self._video_arrays_device(video_id)
        _, V, images, _, patch = self._video_arrays_full(video_id)
        return V, images, patch

    def _video_arrays_full(self, video_id: str):
        """(video dict, V, images (1, Vmax, 3, S, S), per-pixel world
        coordinates (1, Vmax, S, S, 3), patch voxel ids (1, Vmax, g, g, 3))
        for the grounding route (JAX ``_video_arrays(need_full_coords=
        True)``): the host geometry of ``process_3d_video``, then patch
        means and the clip / round discretization, not B1. As in JAX the
        frames and coordinates are zero-padded to ``max_frames``: the tower
        runs on the pad frames too, and their patches (coordinates 0) count
        towards the objects whose boxes hold the origin."""
        self._check_pooling()
        mc = self.cfg
        S = mc.vision.image_size
        Vmax = self.ecfg.max_frames
        vd = self.vp.process_3d_video(video_id, self.ip, force_sample=True,
                                      frames_upbound=Vmax)
        V = vd["video_size"]
        images = np.zeros((1, Vmax, 3, S, S), np.float32)
        images[0, :V] = vd["images"][:V]
        coords_full = np.zeros((1, Vmax, S, S, 3), np.float32)
        coords_full[0, :V] = vd["world_coords"][:V]
        dev = self.device
        coords = torch.from_numpy(coords_full).to(dev)
        patch = geometry.average_coordinate_in_patch(
            coords[0], patch_size=S // self._grid_side()).cpu().numpy()[None]
        vox = mc.world_3d.voxel
        if mc.world_3d.discrete:
            patch = np.clip(patch, vox.min_xyz_range, vox.max_xyz_range)
            patch = np.round((patch - np.asarray(vox.min_xyz_range,
                                                 np.float32))
                             / vox.voxel_size)
        return (vd, V, torch.from_numpy(images).to(dev), coords,
                torch.from_numpy(patch.astype(np.float32)).to(dev))

    def _discretize_box(self, box_input):
        """A Scan2Cap box center -> voxel ids, as the patch coordinates are
        discretized (unchanged when the configuration is not discrete)."""
        vox = self.cfg.world_3d.voxel
        if box_input is None or not self.cfg.world_3d.discrete:
            return box_input
        box_input = np.clip(box_input, vox.min_xyz_range, vox.max_xyz_range)
        return np.round((box_input - np.asarray(vox.min_xyz_range,
                                                np.float32))
                        / vox.voxel_size)

    def _question_text(self, record) -> str:
        qs = record["conversations"][0]["value"]
        qs = self.ecfg.extra_prompt + qs
        if DEFAULT_IMAGE_TOKEN not in qs:
            qs = f"{DEFAULT_IMAGE_TOKEN}\n{qs}"
        return qs

    def _tokenize_prompt(self, record):
        """Prompt ids with an empty assistant turn: the one source of the
        template for generation and for the router's footprints (JAX
        :428). A record of more than two turns is a multi-turn chat: every
        turn goes through ``preprocess_qwen_eval``, ``extra_prompt`` is
        prepended to turn 0, and ``<image>`` is put in turn 0 only when no
        turn carries one (a second sentinel would break the splice plan's
        one-image contract); the trailing ``{"from": "gpt", "value":
        None}`` opens the answer. The scene-prefix cache still applies:
        the prefix (system, turn 0's header, the vision block) does not
        depend on the history, only the suffix grows with it."""
        convs = record["conversations"]
        if len(convs) > 2:
            source = [dict(c) for c in convs]
            source[0]["value"] = self.ecfg.extra_prompt + source[0]["value"]
            if all(DEFAULT_IMAGE_TOKEN not in (c.get("value") or "")
                   for c in source):
                source[0]["value"] = (f"{DEFAULT_IMAGE_TOKEN}\n"
                                      f"{source[0]['value']}")
            return preprocess_qwen_eval(source, self.tokenizer)
        question = {"from": "human", "value": self._question_text(record)}
        return preprocess_qwen_eval(
            [question, {"from": "gpt", "value": None}], self.tokenizer)

    def _splice_plan(self, ids_list, frames, bucket_frames: Optional[int],
                     labels_list=None, coord_token_id=None,
                     answer_budget: bool = True):
        """Splice plan of B prompts with ``frames[b]`` frames each, at the
        bucket fitting the longest prompt with ``bucket_frames`` frames
        (None: the longest of each prompt with its own frames) and, with
        ``answer_budget``, the answer budget. Returns (plan, bucket)."""
        mc = self.cfg
        T = mc.tokens_per_frame
        if bucket_frames is None:
            total = max(len(i) + v * T for i, v in zip(ids_list, frames))
        else:
            total = max(len(i) for i in ids_list) + bucket_frames * T
        if answer_budget:
            total += self.ecfg.max_new_tokens
        L = pick_bucket(total, self.ecfg.buckets)
        plan = build_splice_plan(ids_list, labels_list, frames,
                                 tokens_per_frame=T, max_len=L,
                                 grid_side=self._grid_side(),
                                 coord_token_id=coord_token_id,
                                 truncate_to=mc.tokenizer_model_max_length)
        return plan, L

    def _batch_from_plan(self, plan, images=None, patch=None,
                         box_inputs: Optional[Sequence] = None
                         ) -> lv3d.Batch:
        """SplicePlan (full or suffix slice) -> device Batch. ``box_inputs``:
        per row, a Scan2Cap object's (3,) center in world coordinates or
        None; the batch gets their discretized (B, 3) centers (zeros for
        rows without one) when any row has one."""
        dev = self.device

        def t(a, dtype=torch.long):
            return torch.from_numpy(np.asarray(a)).to(device=dev,
                                                      dtype=dtype)

        boxes = None
        if box_inputs is not None and any(b is not None for b in box_inputs):
            boxes = np.stack([
                self._discretize_box(np.asarray(b, np.float32))
                if b is not None else np.zeros((3,), np.float32)
                for b in box_inputs]).astype(np.float32)
        mrope = self.cfg.world_3d.pos_embed == PosEmbedType.MROPE
        return lv3d.Batch(
            images=None if images is None else images.to(self.dtype),
            patch_coords=patch, text_ids=t(plan.text_ids), kind=t(plan.kind),
            vision_index=t(plan.vision_index),
            position_ids=t(plan.position_ids), seq_len=t(plan.seq_len),
            # the <coord> mask matters only beside a box: no copy without
            coord_mask=None if boxes is None
            else t(plan.coord_mask, torch.bool),
            box_input=None if boxes is None else t(boxes, torch.float32),
            # as in the JAX engine, the plan's mrope ids carry no voxel
            # ids (its plans get no coordinates): text positions
            mrope_position_ids=t(plan.mrope_position_ids) if mrope
            else None)

    def _build_batch(self, ids, V: int, images, patch, box_input=None,
                     coord_token_id=None) -> lv3d.Batch:
        plan, _ = self._splice_plan([ids], [V], V,
                                    coord_token_id=coord_token_id)
        return self._batch_from_plan(plan, images, patch, [box_input])

    def _llava3d_order_keys(self, n: int) -> torch.Tensor:
        """The keys ordering a llava3d scene's n patch rows: the port's
        own draw (``voxel_dedup.default_order_keys``), which departs
        from the JAX engine's ``jax.random.uniform(PRNGKey(0), (n,))``."""
        return default_order_keys(n)

    def _build_llava3d_batch(self, ids, V: int, images, patch):
        """The llava3d variant (JAX ``_build_llava3d_batch``): one block of
        ``llava3d_budget`` voxel-dedup tokens, spliced as one "frame" with
        ``grid_side`` 1, replaces the grid layout. Only the V real frames
        feed the dedup (zero pad frames would alias into voxel 0).
        Returns (batch, the (1, budget, D) block)."""
        n = V * self._grid_side() ** 2
        with torch.inference_mode():
            feat, _ = lv3d.encode_video_llava3d(
                self.params, self.cfg, images[:, :V].to(self.dtype),
                patch[0, :V], order_keys=self._llava3d_order_keys(n))
        T = int(feat.shape[0])
        L = pick_bucket(len(ids) + T + self.ecfg.max_new_tokens,
                        self.ecfg.buckets)
        plan = build_splice_plan([ids], None, [1], tokens_per_frame=T,
                                 max_len=L, grid_side=1,
                                 truncate_to=self.cfg.tokenizer_model_max_length)
        return self._batch_from_plan(plan), feat[None]

    def _check_not_llava3d(self, what: str) -> None:
        """Refuse a path that does not build the llava3d block: JAX's
        batched answers lay a llava3d scene out as the grid (the variant
        ignored) and its grounding scores come out NaN."""
        if self.cfg.world_3d.llava3d:
            raise ValueError(f"{what} does not build the llava3d block (the "
                             f"JAX engine ignores the variant or fails "
                             f"there); answer llava3d records one at a time")

    def _prepare_generation(self, record, box_input=None,
                            coord_token_id=None):
        """record -> (batch, vision_features): the host half of a request
        (vision_features is None unless the scene cache holds the scene).
        ``box_input``: the Scan2Cap object's (3,) center in world
        coordinates, its PE added at the ``coord_token_id`` slot."""
        return self._prepare_generation_ids(self._tokenize_prompt(record),
                                            record, box_input, coord_token_id)

    def _prepare_generation_ids(self, ids, record, box_input=None,
                                coord_token_id=None):
        """With ``scene_cache_scenes > 0`` the spliceable vision features
        (tower -> projector -> pool -> world PE -> newlines) are cached per
        scene: they depend only on the scene's frames, never the question.
        A hit skips video IO, geometry and the tower. A llava3d
        configuration caches nothing (its block is drawn per request, as
        in JAX) and answers from :meth:`_build_llava3d_batch`."""
        llava3d = self.cfg.world_3d.llava3d
        cache_on = self.ecfg.scene_cache_scenes > 0 and not llava3d
        if cache_on:
            with self._cache_lock:
                hit = self._scene_cache.get(record["video"])
                if hit is not None:
                    self._scene_cache.move_to_end(record["video"])
                    self.scene_cache_stats[0] += 1
            if hit is not None:
                spliceable, V = hit
                return self._build_batch(ids, V, None, None, box_input,
                                         coord_token_id), spliceable
        V, images, patch = self._video_arrays(record["video"])
        if llava3d:
            return self._build_llava3d_batch(ids, V, images, patch)
        if not cache_on:
            return self._build_batch(ids, V, images, patch, box_input,
                                     coord_token_id), None
        self.scene_cache_stats[1] += 1
        with torch.inference_mode():
            spliceable = lv3d.encode_video(self.params, self.cfg,
                                           images.to(self.dtype),
                                           patch).spliceable
        with self._cache_lock:
            self._scene_cache[record["video"]] = (spliceable, V)
            while len(self._scene_cache) > self.ecfg.scene_cache_scenes:
                self._scene_cache.popitem(last=False)
        return self._build_batch(ids, V, None, None, box_input,
                                 coord_token_id), spliceable

    def _speculative(self) -> bool:
        """Speculation is on (a draft attached or self-draft layers set)
        and the min-acceptance guard has not turned it off."""
        return (self.draft_params is not None
                or self.ecfg.speculative_draft_layers > 0) \
            and not self._spec_disabled

    def _draft(self):
        """(draft params, draft LLMConfig): the attached draft, else the
        self-draft."""
        if self.draft_params is not None:
            return self.draft_params, self.draft_cfg
        return self._self_draft()

    def _generate(self, batch, vision_features=None,
                  cfg: Optional[ModelConfig] = None) -> GenerateResult:
        """Speculative, beam search, or greedy / sampled decode from a full
        prefill (JAX ``_generate_impl``); beams take precedence over
        speculation. ``cfg`` overrides the model configuration for this
        call only (the plain-video path switches the world PE off); it is
        passed down, never stored on the engine, which other threads read,
        and it keeps the engine's decoder (the drafts and the captured
        decode chunks depend only on that)."""
        ecfg = self.ecfg
        cfg = self.cfg if cfg is None else cfg
        if self._speculative() and ecfg.num_beams == 1:
            dp, dc = self._draft()
            res = spec.generate_speculative(
                self.params, dp, cfg, dc, batch,
                num_draft_tokens=ecfg.speculative_k,
                max_new_tokens=ecfg.max_new_tokens,
                eos_token_id=ecfg.eos_token_id, cache_dtype=self.cache_dtype,
                vision_features=vision_features, **ecfg.sampling())
            self.spec_stats[0] += res.accepted_drafts
            self.spec_stats[1] += res.offered_drafts
            self._check_spec_acceptance()
            return GenerateResult(tokens=res.tokens, lengths=res.lengths)
        if ecfg.num_beams > 1:
            return generate_beam(self.params, cfg, batch,
                                 num_beams=ecfg.num_beams,
                                 max_new_tokens=ecfg.max_new_tokens,
                                 eos_token_id=ecfg.eos_token_id,
                                 cache_dtype=self.cache_dtype,
                                 length_penalty=ecfg.length_penalty,
                                 early_stopping=ecfg.early_stopping,
                                 vision_features=vision_features)
        return generate_greedy(self.params, cfg, batch,
                               max_new_tokens=ecfg.max_new_tokens,
                               eos_token_id=ecfg.eos_token_id,
                               vision_features=vision_features,
                               cache_dtype=self.cache_dtype,
                               graphs=self._graphs, **ecfg.sampling())

    def _generate_from_state(self, state: DecodeState) -> GenerateResult:
        return generate_from_state(self.params, self.cfg, state,
                                   max_new_tokens=self.ecfg.max_new_tokens,
                                   eos_token_id=self.ecfg.eos_token_id,
                                   graphs=self._graphs,
                                   **self.ecfg.sampling())

    def _decode_text(self, toks) -> str:
        text = self.tokenizer.decode(toks, skip_special_tokens=True).strip()
        if self.ecfg.stop_str and text.endswith(self.ecfg.stop_str):
            text = text[: -len(self.ecfg.stop_str)].strip()
        return text

    def _texts(self, res: GenerateResult) -> List[str]:
        tokens, lengths = res.tokens.cpu().numpy(), res.lengths.cpu().numpy()
        return [self._decode_text(t[:n]) for t, n in zip(tokens, lengths)]

    # ------------- scene-prefix KV cache -------------

    def _prefix_cache_base(self, record) -> bool:
        """The scene-prefix preconditions: the cache is on, the record has
        a scene, no beam search (its prefill expands the cache to the
        beams) and not llava3d (its block is drawn per request; JAX
        ``_prefix_cache_base``)."""
        return (self.ecfg.prefix_cache_scenes > 0
                and not self.cfg.world_3d.llava3d
                and self.ecfg.num_beams == 1
                and isinstance(record.get("video"), str))

    def _prefix_cache_on(self, record) -> bool:
        """The scene-prefix path of plain decoding (no speculation: its
        prefix path is :meth:`start_spec_request`)."""
        return (self._prefix_cache_base(record)
                and self.draft_params is None
                and self.ecfg.speculative_draft_layers == 0)

    def _prefix_cache_spec_on(self, record) -> bool:
        """The scene-prefix path of self-draft speculation: the draft is the
        target's first k layers, so both caches seed from the same stored
        prefix. An attached draft cannot reuse the target's prefix."""
        return (self._prefix_cache_base(record)
                and self.draft_params is None
                and self.ecfg.speculative_draft_layers > 0
                and not self._spec_disabled)

    def _lookup_prefix(self, key) -> Optional[_PrefixEntry]:
        with self._cache_lock:
            entry = self._prefix_cache.get(key)
            if entry is not None:
                self._prefix_cache.move_to_end(key)
        return entry

    def _suffix_slice(self, plan, prefix_len: int):
        """Suffix slice of a full plan at the engine's suffix buckets, or
        None when it doesn't fit / truncation cut into the prefix."""
        if np.any(plan.seq_len <= prefix_len):
            return None
        suffix_true = int(np.max(plan.seq_len)) - prefix_len
        Ls = next((b for b in self.ecfg.suffix_buckets if suffix_true <= b),
                  None)
        if Ls is None:
            return None
        return slice_suffix_plan(plan, prefix_len, Ls)

    def _build_suffix_batch(self, ids, entry: _PrefixEntry, box_input=None,
                            coord_token_id=None):
        """Full splice plan -> (suffix-only Batch, bucket) for
        start_decode_prefix, or None when the suffix doesn't fit (the caller
        falls back to a full prefill)."""
        V = entry.num_frames
        plan, L = self._splice_plan([ids], [V], V,
                                    coord_token_id=coord_token_id)
        suf = self._suffix_slice(plan, entry.prefix_len)
        if suf is None:
            return None
        return self._batch_from_plan(suf, box_inputs=[box_input]), L

    def _store_prefix(self, key: str, ids, img: int, batch, cache) -> None:
        """Copy the scene prefix out of a freshly prefilled B=1 cache and
        LRU-insert it. The copy is a clone: a view would keep the whole
        request cache alive and see every later in-place write to it."""
        kind0 = batch.kind[0].cpu().numpy()
        P = vision_end_from_kind(kind0)
        if P == 0 or P >= cache.k.shape[2]:
            return
        V = int((kind0 == KIND_VISION).sum()) // self.cfg.tokens_per_frame
        pre = qwen2.KVCache(*(None if t is None else t[:, :, :P].clone()
                              for t in cache))
        entry = _PrefixEntry(cache=pre, prefix_len=P, num_frames=V,
                             ids_prefix=tuple(ids[:img + 1]))
        evictions = []
        with self._cache_lock:
            self._prefix_cache[key] = entry
            while len(self._prefix_cache) > self.ecfg.prefix_cache_scenes:
                evicted = self._prefix_cache.popitem(last=False)[0]
                # a scene's object features go with its prefix entry
                self._ground_obj_cache.pop(evicted, None)
                evictions.append(evicted)
        for evicted in evictions:
            for hook in self._prefix_evict_hooks:
                hook(evicted)

    def prepare_request(self, record, box_input=None, coord_token_id=None):
        """Host half of the prefix-aware path: tokenize, look up the scene
        prefix, and either build the suffix batch (hit) or run the full
        preparation (miss). Device prefill happens in :meth:`start_request`."""
        ids = self._tokenize_prompt(record)
        img = ids.index(IMAGE_TOKEN_INDEX) if IMAGE_TOKEN_INDEX in ids else -1
        key = record.get("video")
        if self.cfg.world_3d.llava3d:
            # no prefix is stored or read (JAX stores a llava3d prefix here
            # and reads it back as a grid layout's: a departure)
            img = -1
        if img >= 0:
            entry = self._lookup_prefix(key)
            if entry is not None and tuple(ids[:img + 1]) == entry.ids_prefix:
                built = self._build_suffix_batch(ids, entry, box_input,
                                                 coord_token_id)
                if built is not None:
                    return {"mode": "prefix", "batch": built[0],
                            "entry": entry, "key": key, "bucket": built[1]}
        batch, vision_features = self._prepare_generation_ids(
            ids, record, box_input, coord_token_id)
        return {"mode": "full", "batch": batch, "vf": vision_features,
                "ids": ids, "img": img, "key": key, "box_input": box_input,
                "coord_token_id": coord_token_id,
                "bucket": int(batch.text_ids.shape[1])}

    def _refresh_prep(self, prep):
        """Upgrade a full-mode prep to prefix mode when a matching scene
        prefix appeared after :meth:`prepare_request` ran (the next
        question is prepared while the current one, a miss, still runs)."""
        if prep["mode"] != "full" or prep["img"] < 0 \
                or not isinstance(prep["key"], str):
            return prep
        entry = self._lookup_prefix(prep["key"])
        if entry is None or \
                tuple(prep["ids"][:prep["img"] + 1]) != entry.ids_prefix:
            return prep
        built = self._build_suffix_batch(prep["ids"], entry,
                                         prep["box_input"],
                                         prep["coord_token_id"])
        if built is None:
            return prep
        return {"mode": "prefix", "batch": built[0], "entry": entry,
                "key": prep["key"], "bucket": built[1]}

    def start_request(self, prep,
                      max_cache_len: Optional[int] = None) -> DecodeState:
        """Prefill a :meth:`prepare_request` result into a DecodeState.
        ``max_cache_len`` overrides the cache length (the continuous batcher
        passes its row or page-rounded length); the default is bucket +
        max_new_tokens. On a full-prefill miss the scene prefix is stored
        for later questions."""
        prep = self._refresh_prep(prep)
        mcl = (max_cache_len if max_cache_len is not None
               else prep["bucket"] + self.ecfg.max_new_tokens)
        if prep["mode"] == "prefix":
            entry = prep["entry"]
            self.prefix_cache_stats[0] += 1
            return start_decode_prefix(self.params, self.cfg, prep["batch"],
                                       entry.cache, entry.prefix_len, mcl,
                                       self.cache_dtype)
        state = start_decode(self.params, self.cfg, prep["batch"], mcl,
                             prep["vf"], self.cache_dtype)
        if (self.ecfg.prefix_cache_scenes > 0 and prep["img"] >= 0
                and isinstance(prep["key"], str)):
            self.prefix_cache_stats[1] += 1
            self._store_prefix(prep["key"], prep["ids"], prep["img"],
                               prep["batch"], state.cache)
        return state

    def start_request_chunked(self, prep,
                              max_cache_len: Optional[int] = None,
                              chunk_len: int = 256):
        """A :class:`ChunkedPrefill` of a full-mode prep (the continuous
        batcher's cold admission: one chunk per scheduler iteration between
        decode chunks). A prefix-mode prep, already about one decode step
        of work, returns its finished DecodeState from
        :meth:`start_request`."""
        prep = self._refresh_prep(prep)
        if prep["mode"] != "full":
            return self.start_request(prep, max_cache_len=max_cache_len)
        mcl = (max_cache_len if max_cache_len is not None
               else prep["bucket"] + self.ecfg.max_new_tokens)
        return ChunkedPrefill(self.params, self.cfg, prep["batch"], mcl,
                              chunk_len=chunk_len,
                              cache_dtype=self.cache_dtype,
                              vision_features=prep["vf"])

    def finish_chunked(self, prep, state: DecodeState) -> DecodeState:
        """After a chunked prefill, what the atomic full path does: store
        the scene prefix for later questions (before the state is copied
        into a slot)."""
        if (self.ecfg.prefix_cache_scenes > 0 and prep.get("img", -1) >= 0
                and isinstance(prep.get("key"), str)):
            self.prefix_cache_stats[1] += 1
            self._store_prefix(prep["key"], prep["ids"], prep["img"],
                               prep["batch"], state.cache)
        return state

    def _answer_from_prep(self, prep) -> str:
        """Decode of a prepare_request result (the device half)."""
        return self._texts(self._generate_from_state(
            self.start_request(prep)))[0]

    # ------------- speculative decoding -------------

    def _self_draft(self):
        """(params, LLMConfig) of the self-draft of
        ``speculative_draft_layers`` layers: views of the target's tensors,
        so nothing is copied (JAX caches its draft because its cut head is
        a copy)."""
        k = self.ecfg.speculative_draft_layers
        return (spec.self_draft_params(
                    self.params, k,
                    draft_vocab=self.ecfg.speculative_draft_vocab),
                spec.self_draft_config(self.cfg.llm, k))

    def _check_spec_acceptance(self) -> None:
        """The ``speculative_min_acceptance`` guard: after 5 K draft slots,
        an acceptance below it turns speculation off (a bad draft makes
        decoding slower, never wrong)."""
        min_acc = self.ecfg.speculative_min_acceptance
        if min_acc > 0 and not self._spec_disabled \
                and self.spec_stats[1] >= 5 * self.ecfg.speculative_k:
            rate = self.spec_stats[0] / max(self.spec_stats[1], 1)
            if rate < min_acc:
                print(f"[engine] speculative acceptance {rate:.2f} < "
                      f"{min_acc}; falling back to plain decoding")
                self._spec_disabled = True

    def start_spec_request(self, prep, draft_params, draft_cfg,
                           max_cache_len: Optional[int] = None,
                           draft_max_cache_len: Optional[int] = None):
        """Speculative :meth:`start_request`: both models' prefills into a
        one-slot SpecSlots and the first token, suffix-only against the
        stored prefix on a hit (self-drafts), a full prefill storing the
        prefix on a miss. The cache holds bucket + max_new_tokens + K + 2
        slots by default."""
        ecfg = self.ecfg
        prep = self._refresh_prep(prep)
        mcl = (max_cache_len if max_cache_len is not None
               else prep["bucket"] + ecfg.max_new_tokens
               + ecfg.speculative_k + 2)
        if prep["mode"] == "prefix":
            entry = prep["entry"]
            self.prefix_cache_stats[0] += 1
            return spec.spec_start_prefix(
                self.params, draft_params, self.cfg, draft_cfg,
                prep["batch"], entry.cache, entry.prefix_len, mcl,
                self.cache_dtype, draft_max_cache_len=draft_max_cache_len,
                **ecfg.sampling())
        sub, first = spec.spec_start(
            self.params, draft_params, self.cfg, draft_cfg, prep["batch"],
            mcl, self.cache_dtype, vision_features=prep["vf"],
            draft_max_cache_len=draft_max_cache_len, **ecfg.sampling())
        if (ecfg.prefix_cache_scenes > 0 and prep["img"] >= 0
                and isinstance(prep["key"], str)):
            self.prefix_cache_stats[1] += 1
            self._store_prefix(prep["key"], prep["ids"], prep["img"],
                               prep["batch"], sub.t_cache)
        return sub, first

    def _generate_answer_spec_prefix(self, record, box_input=None,
                                     coord_token_id=None, prep=None) -> str:
        """One speculative answer through the scene-prefix cache: the
        self-draft's :meth:`start_spec_request`, then chunks of 4 rounds
        (the batcher's ``spec_decode_chunk``), one host sync each."""
        ecfg = self.ecfg
        dp, dc = self._self_draft()
        if prep is None:
            prep = self.prepare_request(record, box_input, coord_token_id)
        sub, first = self.start_spec_request(prep, dp, dc)
        tok0 = int(first[0])
        if tok0 == ecfg.eos_token_id or ecfg.max_new_tokens == 0:
            return self._decode_text([])
        emitted = [tok0]
        K = ecfg.speculative_k
        done = False
        while not done and len(emitted) < ecfg.max_new_tokens:
            sub, emit, keep = spec.spec_decode_chunk(
                self.params, dp, self.cfg, dc, sub, iters=4,
                num_draft_tokens=K, eos_token_id=ecfg.eos_token_id,
                **ecfg.sampling())
            emit0, keep0 = emit[0].tolist(), keep[0].tolist()
            for row, kept in zip(emit0, keep0):
                toks = [t for t, k in zip(row, kept) if k]
                if not toks:             # the row finished in a round before
                    break
                self.spec_stats[0] += len(toks) - 1
                self.spec_stats[1] += K
                for t in toks:
                    if t == ecfg.eos_token_id:
                        done = True
                        break
                    emitted.append(t)
                    if len(emitted) >= ecfg.max_new_tokens:
                        done = True
                        break
                if done:
                    break
            if bool(sub.done[0]):
                done = True
        self._check_spec_acceptance()
        return self._decode_text(emitted)

    def generate_answer(self, record, box_input=None,
                        coord_token_id=None) -> str:
        if self._prefix_cache_spec_on(record):
            return self._generate_answer_spec_prefix(record, box_input,
                                                     coord_token_id)
        if self._prefix_cache_on(record):
            return self._answer_from_prep(self.prepare_request(
                record, box_input, coord_token_id))
        return self._texts(self._generate(*self._prepare_generation(
            record, box_input, coord_token_id)))[0]

    # ------------- streams and per-call overrides -------------

    def _budget(self, max_new_tokens: Optional[int]) -> int:
        """A per-call token budget, at most the engine's."""
        if max_new_tokens is None:
            return self.ecfg.max_new_tokens
        return max(0, min(self.ecfg.max_new_tokens, int(max_new_tokens)))

    def _call_sampling(self, temperature=None, top_p=None, top_k=None
                       ) -> dict:
        """The decode loops' sampling keywords with per-call overrides."""
        s = self.ecfg.sampling()
        for k, v, cast in (("temperature", temperature, float),
                           ("top_p", top_p, float), ("top_k", top_k, int)):
            if v is not None:
                s[k] = cast(v)
        return s

    def _host_chunks(self, state: DecodeState, chunk: int, budget: int,
                     sampling: dict):
        """Decode a B=1 state in host-driven chunks of ``chunk`` steps
        (JAX's ``decode_chunk`` loop, :963), yielding the ids emitted so
        far after each chunk; the last chunk is cut to the budget, and the
        loop ends after the chunk that emits EOS. The chunks run eagerly
        on the caller's own state: no captured entry, no holder's lock
        held across a ``yield``."""
        if chunk <= 0:
            raise ValueError("chunk must be positive")
        eos = self.ecfg.eos_token_id
        emitted: list = []
        remaining = budget
        while remaining > 0:
            state, toks = decode_chunk(self.params, self.cfg, state,
                                       chunk=min(chunk, remaining),
                                       eos_token_id=eos, capture=False,
                                       **sampling)
            for t in toks[0].tolist():
                if t == eos:
                    remaining = 0
                    break
                emitted.append(t)
                remaining -= 1
            yield emitted
            if bool(state.done[0]):
                break

    def _stream_state(self, record, box_input=None, coord_token_id=None
                      ) -> DecodeState:
        """A request's prefilled B=1 state: through the scene-prefix cache
        when it is on (JAX ``_start_state``, :755), else a full prefill
        into bucket + ``max_new_tokens`` slots."""
        if self._prefix_cache_on(record):
            return self.start_request(self.prepare_request(
                record, box_input, coord_token_id))
        batch, vision_features = self._prepare_generation(
            record, box_input, coord_token_id)
        return start_decode(self.params, self.cfg, batch,
                            batch.text_ids.shape[1]
                            + self.ecfg.max_new_tokens,
                            vision_features, self.cache_dtype)

    def generate_answer_stream(self, record, box_input=None,
                               coord_token_id=None, chunk: int = 16,
                               max_new_tokens: Optional[int] = None,
                               temperature: Optional[float] = None,
                               top_p: Optional[float] = None,
                               top_k: Optional[int] = None):
        """Streaming :meth:`generate_answer` (JAX :921): yields the
        cumulative text after every ``chunk`` decoded tokens; the prefill
        runs once. ``max_new_tokens`` caps this call's answer (at most the
        engine's budget); ``temperature`` / ``top_p`` / ``top_k`` override
        the engine's sampling for this call only. The chunks run eagerly
        (see :meth:`_host_chunks`); their draws equal a captured loop's,
        the hash being keyed by seed, step, row and token."""
        sampling = self._call_sampling(temperature, top_p, top_k)
        budget = self._budget(max_new_tokens)
        state = self._stream_state(record, box_input, coord_token_id)
        for emitted in self._host_chunks(state, chunk, budget, sampling):
            yield self._decode_text(emitted)

    # ------------- real video files and 2D images -------------

    def _chat_ids(self, text: str):
        """Eval-style ids of one human turn (``<image>`` prepended when
        absent) with an empty assistant turn."""
        if DEFAULT_IMAGE_TOKEN not in text:
            text = f"{DEFAULT_IMAGE_TOKEN}\n{text}"
        return preprocess_qwen_eval([{"from": "human", "value": text},
                                     {"from": "gpt", "value": None}],
                                    self.tokenizer)

    def prepare_video_file(self, prompt: str, video_path: str,
                           video_fps: int = 1,
                           add_time_instruction: bool = False):
        """Host half of :meth:`generate_answer_video_file`: (batch, the
        per-call configuration with the world PE off)."""
        from video3d_tpu_torch.data.video_file import (load_video_file,
                                                       time_instruction)

        frames, vtime, ftime, n = load_video_file(
            video_path, video_fps, self.ecfg.max_frames, force_sample=True)
        text = prompt if DEFAULT_IMAGE_TOKEN in prompt \
            else f"{DEFAULT_IMAGE_TOKEN}\n{prompt}"
        if add_time_instruction:
            ti = time_instruction(vtime, n, ftime)
            text = (f"{DEFAULT_IMAGE_TOKEN}\n{ti}\n"
                    f"{text.replace(DEFAULT_IMAGE_TOKEN, '')}")
        V = min(n, self.ecfg.max_frames)
        images = torch.from_numpy(self.ip.preprocess(list(frames[:V])))
        batch = self._build_batch(self._chat_ids(text), V,
                                  images[None].to(self.device), None)
        plain = dataclasses.replace(self.cfg, world_3d=dataclasses.replace(
            self.cfg.world_3d, pos_embed=PosEmbedType.NONE))
        return batch, plain

    def generate_answer_video_file(self, prompt: str, video_path: str,
                                   video_fps: int = 1,
                                   add_time_instruction: bool = False
                                   ) -> str:
        """The legacy LLaVA-Video modality: a real video file (mp4, avi,
        ...), frames sampled with the decord contract (llava/utils.py:25-46
        via ``data/video_file.py``), encoded without the 3D world PE (the
        reference's plain-video path has no world coordinates,
        llava_arch.py:381-429). ``add_time_instruction`` prepends the
        duration and timestamps prompt of train_3d.py:1258-1260."""
        batch, plain = self.prepare_video_file(prompt, video_path, video_fps,
                                               add_time_instruction)
        return self._texts(self._generate(batch, cfg=plain))[0]

    def prepare_image(self, prompt: str, image,
                      image_aspect_ratio: Optional[str] = None,
                      grid_pinpoints=None,
                      patch_merge_type: Optional[str] = None,
                      crop_resolution: int = 768,
                      split_resolution: int = 384):
        """Host half and vision encode of :meth:`generate_answer_image`:
        (batch, the (1, T, D) spliceable image block)."""
        from PIL import Image

        from video3d_tpu_torch.data.anyres import (
            expand2square, process_anyres_image, process_highres_image,
            process_highres_image_crop_split)
        from video3d_tpu_torch.models.anyres import (encode_image_2d,
                                                     encode_tiles)

        aspect = image_aspect_ratio or self.cfg.image_aspect_ratio
        pin = grid_pinpoints if grid_pinpoints is not None \
            else self.cfg.image_grid_pinpoints
        merge = patch_merge_type or self.cfg.mm_patch_merge_type
        if not isinstance(image, Image.Image):
            image = Image.fromarray(np.asarray(image).astype(np.uint8))
        ids = self._chat_ids(prompt)
        if aspect == "pad":
            # one expand2square view, its full unpooled feature grid
            # (mm_utils.py:329-333, no tiling)
            bg = tuple(int(x * 255) for x in self.ip.image_mean)
            tiles = self.ip.preprocess([expand2square(image.convert("RGB"),
                                                      bg)])
        elif aspect == "highres":
            tiles = process_highres_image(image, self.ip, pin)
        elif aspect == "crop_split":
            tiles = process_highres_image_crop_split(
                image, self.ip, crop_resolution, split_resolution)
        else:
            tiles = process_anyres_image(image, self.ip, pin)
        tiles = torch.from_numpy(np.asarray(tiles, np.float32)).to(
            self.device)
        with torch.inference_mode():
            if aspect == "pad":
                feat = encode_tiles(self.params, self.cfg, tiles)[0]
            else:
                feat = encode_image_2d(self.params, self.cfg, tiles,
                                       image.size, pin,
                                       image_aspect_ratio=aspect,
                                       patch_merge_type=merge)
        T = int(feat.shape[0])
        L = pick_bucket(len(ids) + T + self.ecfg.max_new_tokens,
                        self.ecfg.buckets)
        plan = build_splice_plan([ids], None, [1], tokens_per_frame=T,
                                 max_len=L, grid_side=1,
                                 truncate_to=self.cfg.tokenizer_model_max_length)
        return self._batch_from_plan(plan), feat[None]

    def generate_answer_image(self, prompt: str, image,
                              image_aspect_ratio: Optional[str] = None,
                              grid_pinpoints=None,
                              patch_merge_type: Optional[str] = None,
                              crop_resolution: int = 768,
                              split_resolution: int = 384) -> str:
        """2D-image question answering through the tiling paths (the
        reference's image branch, llava_arch.py:518-634, and the aspect
        dispatch of mm_utils.py:303-338): tile the image (``pad``,
        ``anyres``, ``anyres_max_N``, ``highres``, ``crop_split``), encode
        each tile, arrange (``flat``, ``spatial``, ``spatial_unpad``, with
        or without ``nobase``), splice and decode. ``prompt``: the user
        text, an ``<image>`` placeholder marking the insertion point
        (prepended when absent); ``image``: a PIL image or an array PIL can
        read; ``crop_resolution`` and ``split_resolution``: the
        ``crop_split`` knobs (train_3d.py:135-136)."""
        batch, feat = self.prepare_image(
            prompt, image, image_aspect_ratio, grid_pinpoints,
            patch_merge_type, crop_resolution, split_resolution)
        return self._texts(self._generate(batch, vision_features=feat))[0]

    def prepare_images(self, prompt: Optional[str], images,
                       conversations: Optional[Sequence[dict]] = None):
        """Host half and vision encode of :meth:`generate_answer_images`:
        (batch, the (1, N * P, D) block of the N images, frame-major)."""
        from PIL import Image

        from video3d_tpu_torch.data.anyres import expand2square
        from video3d_tpu_torch.models.anyres import encode_tiles

        N = len(images)
        if N < 1:
            raise ValueError("generate_answer_images needs at least one "
                             "image")
        if conversations is not None:
            convs = [dict(c) for c in conversations]
            have = sum((c.get("value") or "").count(DEFAULT_IMAGE_TOKEN)
                       for c in convs)
            if have > N:
                raise ValueError(f"{have} <image> placeholders but only "
                                 f"{N} images")
            if have < N:
                convs[0]["value"] = ((DEFAULT_IMAGE_TOKEN + "\n")
                                     * (N - have)) + (convs[0].get("value")
                                                      or "")
            if convs[-1].get("value"):       # open the answer turn
                convs.append({"from": "gpt", "value": None})
            ids = preprocess_qwen_eval(convs, self.tokenizer)
        else:
            have = prompt.count(DEFAULT_IMAGE_TOKEN)
            if have > N:
                raise ValueError(f"{have} <image> placeholders but only "
                                 f"{N} images")
            prompt = (DEFAULT_IMAGE_TOKEN + "\n") * (N - have) + prompt
            ids = preprocess_qwen_eval(
                [{"from": "human", "value": prompt},
                 {"from": "gpt", "value": None}], self.tokenizer)
        bg = tuple(int(x * 255) for x in self.ip.image_mean)
        pil = [im if isinstance(im, Image.Image)
               else Image.fromarray(np.asarray(im).astype(np.uint8))
               for im in images]
        px = self.ip.preprocess([expand2square(im.convert("RGB"), bg)
                                 for im in pil])
        tiles = torch.from_numpy(np.asarray(px, np.float32)).to(self.device)
        with torch.inference_mode():
            feats = encode_tiles(self.params, self.cfg, tiles)  # (N, P, D)
        T = int(feats.shape[1])
        L = pick_bucket(len(ids) + N * T + self.ecfg.max_new_tokens,
                        self.ecfg.buckets)
        plan = build_splice_plan([ids], None, [N], tokens_per_frame=T,
                                 max_len=L, grid_side=1,
                                 truncate_to=self.cfg.tokenizer_model_max_length)
        return self._batch_from_plan(plan), feats.reshape(1, N * T, -1)

    def generate_answer_images(self, prompt: Optional[str], images,
                               conversations: Optional[Sequence[dict]] = None,
                               max_new_tokens: Optional[int] = None,
                               temperature: Optional[float] = None,
                               top_p: Optional[float] = None,
                               top_k: Optional[int] = None) -> str:
        """Multi-image 2D chat (JAX :1108; the reference's
        gradio_multi_image contract and llava_arch.py:441-470's image-list
        branch): N images, each ``expand2square``'d onto the mean colour,
        through the tower and the projector at its full unpooled grid (no
        2D pool, no world PE), each spliced at its own ``<image>``
        sentinel. Missing sentinels are prepended (in turn 0 when
        ``conversations``, a full human / gpt history, is given; ``prompt``
        is then ignored). ``max_new_tokens`` and the sampling overrides
        apply to this call only, through the host-chunked decode of
        :meth:`generate_answer_stream`; without them the answer is
        :meth:`_generate`'s."""
        batch, feat = self.prepare_images(prompt, images, conversations)
        if (max_new_tokens is None and temperature is None
                and top_p is None and top_k is None):
            return self._texts(self._generate(batch,
                                              vision_features=feat))[0]
        state = start_decode(self.params, self.cfg, batch,
                             batch.text_ids.shape[1]
                             + self.ecfg.max_new_tokens,
                             feat, self.cache_dtype)
        emitted: list = []
        for emitted in self._host_chunks(
                state, 16, self._budget(max_new_tokens),
                self._call_sampling(temperature, top_p, top_k)):
            pass
        return self._decode_text(emitted)

    # ------------- batched generation -------------

    def prepare_answers_batch(self, records: Sequence[dict],
                              box_inputs: Optional[Sequence] = None,
                              coord_token_id=None) -> lv3d.Batch:
        """Host half of :meth:`generate_answers_batch`: video IO, geometry,
        tokenization and one splice plan for B records. The bucket counts
        ``max_frames`` frames, as the JAX engine's; the frames of rows with
        fewer are zero-padded only to the batch's largest V (the plan never
        indexes pad frames)."""
        self._check_not_llava3d("the batched answer path")
        ids_list = [self._tokenize_prompt(r) for r in records]
        arrays = [self._video_arrays(r["video"]) for r in records]
        frames = [V for V, _, _ in arrays]
        plan, _ = self._splice_plan(ids_list, frames, self.ecfg.max_frames,
                                    coord_token_id=coord_token_id)
        Vc = max(frames)
        images = arrays[0][1].new_zeros((len(records), Vc,
                                         *arrays[0][1].shape[2:]))
        patch = arrays[0][2].new_zeros((len(records), Vc,
                                        *arrays[0][2].shape[2:]))
        for b, (V, im, pc) in enumerate(arrays):
            images[b, :V] = im[0, :V]
            patch[b, :V] = pc[0, :V]
        return self._batch_from_plan(plan, images, patch, box_inputs)

    def answers_from_batch(self, batch) -> List[str]:
        """Device half of :meth:`generate_answers_batch`."""
        return self._texts(self._generate(batch))

    def generate_answers_batch(self, records: Sequence[dict],
                               box_inputs: Optional[Sequence] = None,
                               coord_token_id=None) -> List[str]:
        """One prefill and one decode loop for B questions."""
        return self.answers_from_batch(self.prepare_answers_batch(
            records, box_inputs, coord_token_id))

    # ------------- scene-grouped batched suffix decode -------------

    def prepare_answers_batch_prefix(self, records: Sequence[dict],
                                     box_inputs: Optional[Sequence] = None,
                                     coord_token_id=None):
        """B-row SUFFIX batch for records that all sit on one scene with a
        cached prefix: every row shares the scene prefix, so one suffix
        prefill serves B questions. Returns None when the records span
        scenes, the prefix is absent or mismatched, or a suffix doesn't fit
        (the caller falls back)."""
        self._check_not_llava3d("the batched answer path")
        key = records[0].get("video")
        if not isinstance(key, str) or \
                not all(r.get("video") == key for r in records):
            return None
        ids_list = [self._tokenize_prompt(r) for r in records]
        imgs = [ids.index(IMAGE_TOKEN_INDEX) if IMAGE_TOKEN_INDEX in ids
                else -1 for ids in ids_list]
        if min(imgs) < 0:
            return None
        entry = self._lookup_prefix(key)
        if entry is None or any(tuple(ids[:img + 1]) != entry.ids_prefix
                                for ids, img in zip(ids_list, imgs)):
            return None
        V = entry.num_frames
        plan, L = self._splice_plan(ids_list, [V] * len(records), V,
                                    coord_token_id=coord_token_id)
        suf = self._suffix_slice(plan, entry.prefix_len)
        if suf is None:
            return None
        return {"mode": "prefix_batch",
                "batch": self._batch_from_plan(suf, box_inputs=box_inputs),
                "entry": entry, "bucket": L}

    def answers_from_prefix_batch(self, prep) -> List[str]:
        """Device half of the scene-grouped suffix batch."""
        entry, batch = prep["entry"], prep["batch"]
        state = start_decode_prefix(
            self.params, self.cfg, batch, entry.cache, entry.prefix_len,
            prep["bucket"] + self.ecfg.max_new_tokens, self.cache_dtype)
        self.prefix_cache_stats[0] += int(batch.text_ids.shape[0])
        return self._texts(self._generate_from_state(state))

    def generate_answers_batch_prefix(self, records: Sequence[dict],
                                      box_inputs: Optional[Sequence] = None,
                                      coord_token_id=None) -> List[str]:
        """Batched answers with the scene-prefix fast path: a same-scene
        chunk with a cached prefix decodes as one B-row suffix batch; a
        same-scene chunk WITHOUT one answers its first record alone (full
        prefill, storing the prefix) and then suffix-batches the rest;
        anything else takes the plain batched path."""
        if box_inputs is None:
            box_inputs = [None] * len(records)
        prep = self.prepare_answers_batch_prefix(records, box_inputs,
                                                 coord_token_id)
        if prep is not None:
            return self.answers_from_prefix_batch(prep)
        key = records[0].get("video")
        same_scene = isinstance(key, str) and \
            all(r.get("video") == key for r in records)
        with self._cache_lock:
            have_entry = key in self._prefix_cache
        # store-then-suffix only when the scene has NO prefix yet: if one
        # exists but was unusable (e.g. a suffix past every suffix bucket),
        # recursion would degrade the chunk to B sequential full prefills
        if same_scene and len(records) > 1 and not have_entry \
                and self._prefix_cache_on(records[0]):
            first = self.generate_answer(records[0], box_inputs[0],
                                         coord_token_id)
            return [first] + self.generate_answers_batch_prefix(
                records[1:], box_inputs[1:], coord_token_id)
        return self.generate_answers_batch(records, box_inputs,
                                           coord_token_id)

    # ------------- discriminative (grounding) -------------

    def _ground_tokenize(self, record):
        """Training-style ids and labels of the query and its ``<ground>``
        answer (the reference grounds at the answer's token)."""
        question = {"from": "human", "value": self._question_text(record)}
        tok = preprocess_qwen([[question, record["conversations"][1]]],
                              self.tokenizer, has_image=True)
        return tok["input_ids"][0].tolist(), tok["labels"][0].tolist()

    def _ground_slot(self, plan, b: int) -> int:
        """Spliced index of row b's first ``<ground>`` label, else its last
        token."""
        hits = np.nonzero(plan.labels[b] == self.ecfg.ground_token_id)[0]
        return int(hits[0]) if len(hits) else int(plan.seq_len[b]) - 1

    def _proposals(self, vd):
        """The scene's proposals padded to ``max_objects``: (boxes (N, 6),
        valid (N,) on the device, the objects (n0, 6) numpy, n real)."""
        objects = np.asarray(vd["objects"], np.float32).reshape(-1, 6)
        N = self.ecfg.max_objects
        n = min(len(objects), N)
        obj = np.zeros((N, 6), np.float32)
        obj[:n] = objects[:n]
        valid = np.zeros((N,), bool)
        valid[:n] = True
        return (torch.from_numpy(obj).to(self.device),
                torch.from_numpy(valid).to(self.device), objects, n)

    @staticmethod
    def _compact(scores: torch.Tensor, n: int) -> np.ndarray:
        """The n real objects' scores and the last slot (the zero target),
        the reference's layout."""
        s = scores.float().cpu().numpy()
        return np.concatenate([s[:n], s[-1:]])

    def _check_ground(self) -> None:
        self._check_not_llava3d("grounding")
        if self.ecfg.ground_token_id is None:
            raise ValueError("grounding needs EngineConfig.ground_token_id")

    def _ground_inputs(self, ids, labels, video_id: str,
                       prepared_video=None):
        """One query's full grounding forward inputs: (batch, bucket,
        coordinates (Vmax, S, S, 3), boxes, valid, <ground> slot, objects,
        n). ``prepared_video``: a :meth:`_video_arrays_full` result loaded
        beforehand."""
        vd, V, images, coords, patch = (
            prepared_video if prepared_video is not None
            else self._video_arrays_full(video_id))
        plan, L = self._splice_plan([ids], [V], V, [labels])
        obj, valid, objects, n = self._proposals(vd)
        return (self._batch_from_plan(plan, images, patch), L, coords[0],
                obj, valid, self._ground_slot(plan, 0), objects, n)

    def ground(self, record, prepared_video=None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """(scores (n+1,), objects (n, 6)) for one query; through the
        scene-prefix cache when it is on."""
        self._check_ground()
        if self._prefix_cache_on(record):
            return self._ground_prefix(record, prepared_video)
        ids, labels = self._ground_tokenize(record)
        batch, _, coords, obj, valid, slot, objects, n = self._ground_inputs(
            ids, labels, record["video"], prepared_video)
        with torch.inference_mode():
            scores = lv3d.grounding_forward(self.params, self.cfg, batch,
                                            coords, obj, valid, slot)
        return self._compact(scores, n), objects[:n]

    def _ground_prefix(self, record, prepared_video=None
                       ) -> Tuple[np.ndarray, np.ndarray]:
        """:meth:`ground` through the scene-prefix cache. The prefix KV, the
        proposals and their object features are question-independent, so
        a hit prefills only the query suffix (which holds the ``<ground>``
        token) and scores the cached features: no video IO, coordinates,
        masks, tower or full prefill. A miss (or a suffix that does not
        fit) runs the full forward through a cache and stores the prefix
        and the object features."""
        ids, labels = self._ground_tokenize(record)
        img = ids.index(IMAGE_TOKEN_INDEX) if IMAGE_TOKEN_INDEX in ids else -1
        key = record.get("video")
        entry = obj_entry = None
        if img >= 0:
            with self._cache_lock:
                entry = self._prefix_cache.get(key)
                obj_entry = self._ground_obj_cache.get(key)
                if entry is not None:
                    self._prefix_cache.move_to_end(key)
                if obj_entry is not None:
                    self._ground_obj_cache.move_to_end(key)
        if (entry is not None and obj_entry is not None
                and tuple(ids[:img + 1]) == entry.ids_prefix):
            P, V = entry.prefix_len, entry.num_frames
            plan, _ = self._splice_plan([ids], [V], V, [labels],
                                        answer_budget=False)
            slot = self._ground_slot(plan, 0)
            suf = self._suffix_slice(plan, P)
            if suf is not None and slot >= P:
                obj_feats, valid, objects, n = obj_entry
                scores = ground_suffix(
                    self.params, self.cfg, self._batch_from_plan(suf),
                    entry.cache, P, P + suf.text_ids.shape[1],
                    self.cache_dtype, obj_feats, valid, slot)
                self.prefix_cache_stats[0] += 1
                return self._compact(scores, n), objects[:n]
        batch, L, coords, obj, valid, slot, objects, n = self._ground_inputs(
            ids, labels, record["video"], prepared_video)
        scores, cache, obj_feats = lv3d.grounding_forward_cached(
            self.params, self.cfg, batch, coords, obj, valid, slot, L,
            self.cache_dtype)
        if img >= 0 and isinstance(key, str):
            self.prefix_cache_stats[1] += 1
            self._store_prefix(key, ids, img, batch, cache)
            with self._cache_lock:
                # features that can never hit (no prefix entry) hold no
                # device memory
                if key in self._prefix_cache:
                    self._ground_obj_cache[key] = (obj_feats, valid, objects,
                                                   n)
                    while len(self._ground_obj_cache) > \
                            self.ecfg.prefix_cache_scenes:
                        self._ground_obj_cache.popitem(last=False)
        return self._compact(scores, n), objects[:n]

    def ground_batch(self, records: Sequence[dict]
                     ) -> List[Tuple[np.ndarray, np.ndarray]]:
        """Batched :meth:`ground` without the prefix cache: one prefill
        scores B queries."""
        return self.ground_from_prepared(self.prepare_ground_batch(records))

    def prepare_ground_batch(self, records: Sequence[dict]):
        """Host half of :meth:`ground_batch`: video IO, coordinates,
        tokenization, one splice plan and the padded proposals."""
        self._check_ground()
        toks = [self._ground_tokenize(r) for r in records]
        videos = [self._video_arrays_full(r["video"]) for r in records]
        plan, _ = self._splice_plan([i for i, _ in toks],
                                    [v[1] for v in videos], None,
                                    [lab for _, lab in toks],
                                    answer_budget=False)
        batch = self._batch_from_plan(plan, torch.cat([v[2] for v in videos]),
                                      torch.cat([v[4] for v in videos]))
        props = [self._proposals(v[0]) for v in videos]
        return (batch, torch.cat([v[3] for v in videos]),
                torch.stack([p[0] for p in props]),
                torch.stack([p[1] for p in props]),
                [self._ground_slot(plan, b) for b in range(len(records))],
                [p[3] for p in props], [p[2] for p in props])

    def ground_from_prepared(self, prepared
                             ) -> List[Tuple[np.ndarray, np.ndarray]]:
        """Device half of :meth:`ground_batch`."""
        batch, coords, obj, valid, slots, counts, objects_l = prepared
        with torch.inference_mode():
            scores = lv3d.grounding_forward_batch(
                self.params, self.cfg, batch, coords, obj, valid, slots)
        return [(self._compact(scores[b], n), objects_l[b][:n])
                for b, n in enumerate(counts)]


def _append_jsonl(path: str, record: dict) -> None:
    """Locked append (several driver processes may share one file)."""
    import fcntl

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            f.write(json.dumps(record) + "\n")
            f.flush()
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def run_generative(engine: InferenceEngine, questions: Sequence[dict],
                   answer_file: str, gt_from_annotations: bool = False,
                   coord_token_id=None, batch_size: int = 1) -> List[float]:
    """ScanQA / SQA3D / Scan2Cap loop over chunks of ``batch_size``
    questions. A worker thread prepares chunk i+1 (frame IO, geometry,
    tokenization, splice plan) while the device generates chunk i. With
    the prefix cache on and ``batch_size > 1``, questions are sorted by
    scene so each chunk is one scene-grouped suffix batch (records are
    keyed by sample_id, so the changed order does not matter to the
    metrics). A record's ``box_input`` (its first three values, the
    object's center) is added at the ``coord_token_id`` slot;
    ``gt_from_annotations`` takes the record's ``annotations`` as the
    ground truth (Scan2Cap). Returns seconds per question (a chunk's time
    over its size), prep excluded, as the JAX driver times it."""
    if not questions:
        return []
    plain_prefix = engine._prefix_cache_on(questions[0])
    spec_prefix = batch_size == 1 and \
        engine._prefix_cache_spec_on(questions[0])
    prefix_on = plain_prefix or spec_prefix
    if plain_prefix and batch_size > 1:
        questions = sorted(questions, key=lambda q: str(q.get("video")))

    def prep(s):
        chunk = list(questions[s:s + batch_size])
        boxes = [np.asarray(q["box_input"][:3], np.float32)
                 if q.get("box_input") is not None else None for q in chunk]
        if prefix_on and batch_size == 1:
            prepared = engine.prepare_request(chunk[0], boxes[0],
                                              coord_token_id)
        elif prefix_on:
            # host-cheap on hits; the miss (once per scene) stores the
            # prefix inside the timed section
            prepared = None
        elif batch_size == 1:
            prepared = engine._prepare_generation(chunk[0], boxes[0],
                                                  coord_token_id)
        else:
            prepared = engine.prepare_answers_batch(chunk, boxes,
                                                    coord_token_id)
        return chunk, boxes, prepared

    times = []
    with ThreadPoolExecutor(max_workers=1) as ex:
        fut = ex.submit(prep, 0)
        for s in range(0, len(questions), batch_size):
            chunk, boxes, prepared = fut.result()
            if s + batch_size < len(questions):
                fut = ex.submit(prep, s + batch_size)
            t0 = time.time()
            if prefix_on and batch_size > 1:
                texts = engine.generate_answers_batch_prefix(
                    chunk, boxes, coord_token_id)
            elif spec_prefix and not engine._spec_disabled:
                texts = [engine._generate_answer_spec_prefix(
                    chunk[0], boxes[0], coord_token_id, prep=prepared)]
            elif prefix_on:
                # plain, or speculation turned off by the min-acceptance
                # guard mid-run: the prep decodes through the prefix path
                texts = [engine._answer_from_prep(prepared)]
            elif batch_size == 1:
                texts = engine._texts(engine._generate(*prepared))
            else:
                texts = engine.answers_from_batch(prepared)
            dt = (time.time() - t0) / len(chunk)
            for line, text in zip(chunk, texts):
                times.append(dt)
                gt = (line.get("annotations",
                               [line["conversations"][1]["value"]])
                      if gt_from_annotations
                      else line["conversations"][1]["value"])
                _append_jsonl(answer_file, {
                    "dataset": line["metadata"]["dataset"],
                    "sample_id": line["id"],
                    "prompt": line["conversations"][0]["value"],
                    "pred_response": text,
                    "gt_response": gt,
                    "question_type": line["metadata"].get("question_type"),
                })
    return times


def run_scanqa(engine, questions, answer_file):
    return run_generative(engine, questions, answer_file)


def run_sqa3d(engine, questions, answer_file):
    return run_generative(engine, questions, answer_file)


def run_scan2cap(engine, questions, answer_file, coord_token_id,
                 batch_size: int = 1):
    return run_generative(engine, questions, answer_file,
                          gt_from_annotations=True,
                          coord_token_id=coord_token_id,
                          batch_size=batch_size)


def run_vqa(engine: InferenceEngine, questions: Sequence[dict],
            answer_file: str) -> List[float]:
    """Free-form prompts over scenes, no ground-truth assumptions."""
    times = []
    for line in questions:
        t0 = time.time()
        text = engine.generate_answer(line)
        times.append(time.time() - t0)
        _append_jsonl(answer_file, {
            "sample_id": line.get("id"),
            "prompt": line["conversations"][0]["value"],
            "pred_response": text,
            "gt_response": (line["conversations"][1].get("value")
                            if len(line["conversations"]) > 1 else None),
        })
    return times


def _run_grounding(engine: InferenceEngine, questions: Sequence[dict],
                   batch_size: int, emit) -> List[float]:
    """ScanRefer / Multi3DRefer loop: one worker thread prepares chunk i+1
    while the device scores chunk i. At ``batch_size`` 1 with the prefix
    cache on each query goes through :meth:`InferenceEngine.ground` (a
    scene miss has its video arrays loaded on the worker); otherwise
    through one batched forward per chunk. Returns seconds per query,
    prep excluded."""
    if not questions:
        return []

    def prep(s0):
        chunk = list(questions[s0:s0 + batch_size])
        if batch_size == 1 and engine._prefix_cache_on(chunk[0]):
            with engine._cache_lock:
                have = chunk[0].get("video") in engine._prefix_cache
            return chunk, "prefix", (None if have else
                                     engine._video_arrays_full(
                                         chunk[0]["video"]))
        return chunk, "batch", engine.prepare_ground_batch(chunk)

    times = []
    with ThreadPoolExecutor(max_workers=1) as ex:
        fut = ex.submit(prep, 0)
        for s0 in range(0, len(questions), batch_size):
            chunk, mode, prepared = fut.result()
            if s0 + batch_size < len(questions):
                fut = ex.submit(prep, s0 + batch_size)
            t0 = time.time()
            if mode == "prefix":
                results = [engine.ground(chunk[0], prepared_video=prepared)]
            else:
                results = engine.ground_from_prepared(prepared)
            dt = (time.time() - t0) / len(chunk)
            for line, (scores, objects) in zip(chunk, results):
                times.append(dt)
                emit(line, scores, objects)
    return times


def run_scanrefer(engine: InferenceEngine, questions: Sequence[dict],
                  answer_file: str, batch_size: int = 1) -> List[float]:
    """The argmax proposal's box per query; ``batch_size > 1`` scores
    several queries per prefill."""
    return _run_grounding(
        engine, questions, batch_size,
        lambda line, scores, objects:
            _emit_scanrefer(answer_file, line, scores, objects))


def _emit_scanrefer(answer_file, line, scores, objects):
    if len(objects) and int(np.argmax(scores)) < len(objects):
        pred_box = objects[int(np.argmax(scores))].tolist()
    elif len(objects):
        pred_box = objects[int(np.argmax(scores[:-1]))].tolist()
    else:
        pred_box = [0.0] * 6
    _append_jsonl(answer_file, {
        "dataset": line["metadata"]["dataset"],
        "sample_id": line["id"],
        "pred_response": pred_box,
        "gt_response": line["metadata"]["gt_box"]
        if "gt_box" in line["metadata"] else line.get("box"),
        "question_type": line["metadata"].get("question_type"),
    })


def run_multi3drefer(engine: InferenceEngine, questions: Sequence[dict],
                     answer_file: str, batch_size: int = 1) -> List[float]:
    """Every proposal's score and box per query (the protocol picks)."""
    def emit(line, scores, objects):
        _append_jsonl(answer_file, {
            "dataset": line["metadata"]["dataset"],
            "sample_id": line["id"],
            "scores": scores.tolist(),
            "objects": objects.tolist(),
            "gt_response": line.get("box", []),
            "question_type": line["metadata"].get("question_type"),
        })

    return _run_grounding(engine, questions, batch_size, emit)
