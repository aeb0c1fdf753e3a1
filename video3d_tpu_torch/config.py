"""Typed configuration tree for the whole framework.

The reference wires its 3D knobs through substring-matched strings overlaid
onto an HF config (e.g. ``world_position_embedding_type="avg-discrete-sin3d"``,
the reference llava/model/llava_arch.py:395-429, train_3d.py:1425-1475).
Here every behavior switch is an explicit enum/dataclass field so configs are
self-documenting, validated at construction, and hashable for jit static args.

The port's own copy of ``video3d_tpu/config.py`` (the port imports
nothing of the JAX package).
"""

from __future__ import annotations

import dataclasses
import enum
from dataclasses import dataclass, field
from typing import Optional, Tuple, Union


class CoordPooling(str, enum.Enum):
    """How 384x384 per-pixel world coords reduce to per-patch coords.

    Reference: llava_arch.py:213-257 ('avg'/'minmax'/'sample9'/'sample5'/'sample1').
    """

    AVG = "avg"
    MINMAX = "minmax"
    SAMPLE9 = "sample9"
    SAMPLE5 = "sample5"
    SAMPLE1 = "sample1"

    @property
    def n_points(self) -> int:
        return {"avg": 1, "minmax": 2, "sample9": 9, "sample5": 5, "sample1": 1}[self.value]


class PosEmbedType(str, enum.Enum):
    """Which world-position embedding is added to vision features.

    Reference: llava_arch.py:422-429 ('sin3d' / 'mlp' / 'mrope').
    """

    NONE = "none"
    SIN3D = "sin3d"
    MLP = "mlp"
    MROPE = "mrope"  # 3-axis rotary position ids instead of additive PE


class SpatialPoolMode(str, enum.Enum):
    """2D token pooling 729->196 (llava_arch.py:191-210)."""

    AVERAGE = "average"
    MAX = "max"
    BILINEAR = "bilinear"


class NewlinePosition(str, enum.Enum):
    """Where image_newline separator tokens are inserted (llava_arch.py:534-569)."""

    GRID = "grid"      # one newline per 14-token row => 210 tokens/frame
    FRAME = "frame"
    ONE_TOKEN = "one_token"
    NO_TOKEN = "no_token"


class FrameSampling(str, enum.Enum):
    """Runtime frame selection strategy (video_utils.py:131-194)."""

    UNIFORM = "uniform"
    MC = "mc"            # full precomputed max-coverage order (<= upbound)
    MC_RATIO90 = "mc-ratio90"
    MC_RATIO95 = "mc-ratio95"


class ObjectFeatureType(str, enum.Enum):
    """Object-proposal patch membership rule (llava_arch.py:367-378)."""

    PATCH27 = "patch27"  # >=25% of the 27x27 pixels inside the AABB
    PATCH14 = "patch14"  # >=50% of a 14x14 subsample inside the AABB


class GroundHeadType(str, enum.Enum):
    """Grounding head variant (llava_qwen.py:57-113)."""

    NONE = "none"
    MLP = "mlp"
    SCORE = "score"
    INFONCE = "infonce"


@dataclass(frozen=True)
class VoxelConfig:
    """Voxel discretization of world coords (llava_arch.py:259-272)."""

    voxel_size: float = 0.1
    min_xyz_range: Tuple[float, float, float] = (-15.0, -15.0, -5.0)
    max_xyz_range: Tuple[float, float, float] = (15.0, 15.0, 5.0)

    @property
    def grid_dims(self) -> Tuple[int, int, int]:
        """Number of voxels per axis (ids in [0, dim], inclusive of the
        clamped max — hence the +2)."""
        return tuple(int((hi - lo) / self.voxel_size) + 2
                     for lo, hi in zip(self.min_xyz_range, self.max_xyz_range))


@dataclass(frozen=True)
class World3DConfig:
    """All 3D-awareness knobs; replaces 'avg-discrete-sin3d' style strings."""

    pooling: CoordPooling = CoordPooling.AVG
    discrete: bool = True                   # voxel-discretize before PE
    pos_embed: PosEmbedType = PosEmbedType.SIN3D
    voxel: VoxelConfig = field(default_factory=VoxelConfig)
    pe_temperature: float = 10000.0
    # box-center PE added to object proposal features + <coord> input PE
    object_feature_type: ObjectFeatureType = ObjectFeatureType.PATCH14
    object_feature_use_pe: bool = True      # 'patch14-pe'
    # 'llava3d' variant (llava_arch.py:731-746): replace the grid-token
    # layout by voxel-deduplicated mean features sampled to a budget
    llava3d: bool = False
    llava3d_budget: int = 3096

    @classmethod
    def from_reference_string(cls, s: str, voxel: Optional[VoxelConfig] = None) -> "World3DConfig":
        """Parse a reference-style flag string like 'avg-discrete-sin3d'."""
        pooling = CoordPooling.AVG
        for p in CoordPooling:
            if p.value in s:
                pooling = p
                break
        pe = PosEmbedType.NONE
        if "sin3d" in s:
            pe = PosEmbedType.SIN3D
        elif "mlp" in s:
            pe = PosEmbedType.MLP
        elif "mrope" in s:
            pe = PosEmbedType.MROPE
        return cls(pooling=pooling, discrete=("discrete" in s), pos_embed=pe,
                   voxel=voxel or VoxelConfig(), llava3d=("llava3d" in s))


@dataclass(frozen=True)
class VisionConfig:
    """SigLIP so400m-patch14-384 tower (siglip_encoder.py:70-100).

    ``num_hidden_layers`` counts layers actually run: the reference builds 27
    and deletes the last (siglip_encoder.py:570-571), so the default is 26.
    """

    hidden_size: int = 1152
    intermediate_size: int = 4304
    num_hidden_layers: int = 26
    num_attention_heads: int = 16
    image_size: int = 384
    patch_size: int = 14
    layer_norm_eps: float = 1e-6
    # Optional MXU-aligned padded sequence length for the encoder stack
    # (e.g. 768 for the 729-patch so400m). None = run at num_patches.
    # Pad keys are softmax-masked so outputs match the unpadded run to
    # reduction-tree rounding (tests/test_siglip_pad.py); flip on only if
    # it measures faster on the target chip (scripts/bench/tower_profile.py).
    tower_pad_seq: Optional[int] = None

    @property
    def num_patches_per_side(self) -> int:
        return self.image_size // self.patch_size  # 27

    @property
    def num_patches(self) -> int:
        return self.num_patches_per_side ** 2      # 729


@dataclass(frozen=True)
class MoEConfig:
    """Qwen2-MoE block (HF qwen2_moe; reference llava_qwen_moe wrapper)."""

    num_experts: int = 8
    num_experts_per_tok: int = 2
    moe_intermediate_size: int = 64
    # None -> no shared expert (Mixtral); set -> Qwen2-MoE shared expert
    shared_expert_intermediate_size: Optional[int] = 64
    norm_topk_prob: bool = False


@dataclass(frozen=True)
class LLMConfig:
    """Qwen2-7B-Instruct decoder (qwen2/modeling_qwen2.py)."""

    vocab_size: int = 152064
    hidden_size: int = 3584
    intermediate_size: int = 18944
    num_hidden_layers: int = 28
    num_attention_heads: int = 28
    num_key_value_heads: int = 4
    head_dim: int = 128
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1_000_000.0
    max_position_embeddings: int = 32768
    tie_word_embeddings: bool = False
    attention_bias: bool = True   # Qwen2 has qkv bias; LLaMA-family does not
    moe: Optional[MoEConfig] = None   # sparse-MoE MLP when set
    # family knobs (Gemma: "gelu_tanh" MLP, (1+w) RMSNorm, sqrt(D) embed scale)
    hidden_act: str = "silu"
    rms_norm_add_unit_offset: bool = False
    embed_scale: bool = False
    # MPT family (HF modeling_mpt): ALiBi key-position bias instead of RoPE,
    # mean-subtracting LayerNorm instead of RMSNorm, ungated GELU MLP
    position_embedding: str = "rope"    # "rope" | "alibi"
    norm_type: str = "rmsnorm"          # "rmsnorm" | "layernorm"
    alibi_bias_max: float = 8.0
    # 3-axis mRoPE split of the 64 rotary freqs (modeling_qwen2.py:162)
    mrope_section: Tuple[int, int, int] = (32, 16, 16)

    @classmethod
    def tiny(cls) -> "LLMConfig":
        """Small config for CPU tests."""
        return cls(vocab_size=512, hidden_size=64, intermediate_size=128,
                   num_hidden_layers=2, num_attention_heads=4,
                   num_key_value_heads=2, head_dim=16,
                   max_position_embeddings=1024, mrope_section=(4, 2, 2))


@dataclass(frozen=True)
class ProjectorConfig:
    """mm projector (multimodal_projector/builder.py:32-65)."""

    projector_type: str = "mlp2x_gelu"  # Linear(1152,3584) GELU Linear(3584,3584)


@dataclass(frozen=True)
class ModelConfig:
    vision: VisionConfig = field(default_factory=VisionConfig)
    llm: LLMConfig = field(default_factory=LLMConfig)
    projector: ProjectorConfig = field(default_factory=ProjectorConfig)
    world_3d: World3DConfig = field(default_factory=World3DConfig)
    spatial_pool_mode: SpatialPoolMode = SpatialPoolMode.BILINEAR
    spatial_pool_stride: int = 2
    newline_position: NewlinePosition = NewlinePosition.GRID
    ground_head: GroundHeadType = GroundHeadType.INFONCE
    ground_head_temperature: float = 0.07
    tokenizer_model_max_length: int = 32768
    # 2D-image (non-video) path: anyres tiling knobs the reference persists
    # into config.json (image_aspect_ratio / image_grid_pinpoints /
    # mm_patch_merge_type). grid pinpoints: tuple of (w, h) pixel
    # resolutions, or the reference's "(1x1),...,(6x6)" range string.
    image_aspect_ratio: str = "anyres"
    image_grid_pinpoints: Union[str, Tuple[Tuple[int, int], ...]] = (
        (384, 768), (768, 384), (768, 768), (1152, 384), (384, 1152))
    mm_patch_merge_type: str = "spatial_unpad"
    # mm_resampler_type (multimodal_resampler/builder.py:21-32): None ->
    # identity. Like the reference (whose encode_images has the resampler
    # call commented out, llava_arch.py:277), a configured resampler is
    # built/loaded but not routed through the 3D video path; apply it via
    # models.resampler.apply_resampler on 2D features.
    resampler_type: Optional[str] = None

    @property
    def tokens_per_frame(self) -> int:
        side = self.vision.num_patches_per_side  # 27
        pooled = -(-side // self.spatial_pool_stride)  # ceil -> 14
        if self.newline_position == NewlinePosition.GRID:
            return pooled * (pooled + 1)  # 14*15 = 210
        if self.newline_position == NewlinePosition.FRAME:
            return pooled * pooled + 1
        if self.newline_position == NewlinePosition.ONE_TOKEN:
            raise NotImplementedError(
                "one_token adds a single global token, not a per-frame count; "
                "use total_vision_tokens()")
        return pooled * pooled

    def total_vision_tokens(self, num_frames: int) -> int:
        if self.newline_position == NewlinePosition.ONE_TOKEN:
            side = self.vision.num_patches_per_side
            pooled = -(-side // self.spatial_pool_stride)
            return num_frames * pooled * pooled + 1
        return num_frames * self.tokens_per_frame

    @classmethod
    def tiny(cls) -> "ModelConfig":
        return cls(
            vision=VisionConfig(hidden_size=32, intermediate_size=64,
                                num_hidden_layers=2, num_attention_heads=4,
                                image_size=56, patch_size=14),
            llm=LLMConfig.tiny(),
        )


@dataclass(frozen=True)
class DataConfig:
    video_folder: str = "data"
    annotation_dir: str = "data/embodiedscan"
    metadata_dir: str = "data/metadata"
    frames_upbound: int = 32
    frame_sampling: FrameSampling = FrameSampling.UNIFORM
    val_box_type: str = "pred"
    add_spatial_instruction: bool = True
    crop_strategy: str = "center_crop"     # or 'resize'
    # clamp world coords to the scene point-cloud bounds ('norm' in the
    # reference's frame_sampling_strategy string, video_utils.py:232-234)
    normalize_coords: bool = False
    # directory of packed per-scene depth/pose bundles (tools/pack_scenes.py);
    # None -> per-frame PNG/txt reads like the reference
    packed_dir: Optional[str] = None
    # 2D-image training samples (train_3d.py:1130-1160 image branch /
    # DataArguments image_folder + aspect knobs)
    image_folder: Optional[str] = None
    image_aspect_ratio: str = "anyres"
    image_grid_pinpoints: Union[str, Tuple[Tuple[int, int], ...]] = (
        (384, 768), (768, 384), (768, 768), (1152, 384), (384, 1152))
    # real video files (mp4/...) in the dataset's "video" field: the legacy
    # LLaVA-Video modality (train.py:1194, DataArguments video_fps /
    # add_time_instruction, train_3d.py:140-142). Trains plain-video (no
    # world PE) — pair with world_position_embedding_type 'none'.
    video_fps: int = 1
    add_time_instruction: bool = False


def replace(cfg, **kwargs):
    """dataclasses.replace passthrough, re-exported for convenience."""
    return dataclasses.replace(cfg, **kwargs)
