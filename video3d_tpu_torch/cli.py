"""Command-line entry points of the port: counterpart of
``video3d_tpu/cli.py``.

``python -m video3d_tpu_torch.cli train ...`` trains (the reference's
``torchrun llava/train/train_3d.py``) and ``python -m
video3d_tpu_torch.cli eval-{scanqa,sqa3d,scan2cap,scanrefer,multi3drefer}
...`` runs an evaluation (the reference's Ray drivers), with the JAX CLI's
flags. Everything runs on the first CUDA card unless ``--device`` names
another (``--device cpu`` for the CPU); without a card the default raises.

``--model-path`` is an HF-format checkpoint directory (``config.json`` +
``*.safetensors``: ``builder.load_pretrained_model``) or, with
``--load-format dummy``, a directory holding only ``config.json`` (random
weights drawn on the card, ``builder.load_dummy_model``). A directory
without ``config.json`` holds a trainer export (``params.pt``), its
architecture from the flags (JAX's orbax directories).

The meshes (``--tp`` / ``--dp`` / ``--sp`` above 1, ROADMAP A12) are not
ported and raise.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

PE_KINDS = ("sin3d", "mlp", "mrope", "llava3d", "none")


def _load_tokenizer(path: str):
    from transformers import AutoTokenizer

    return AutoTokenizer.from_pretrained(path)


def _overrides(args) -> dict:
    """The 3D flags the user set -> config.json overrides (the defaults
    are None, so a checkpoint's persisted knobs win otherwise)."""
    keys = {"world_position_embedding_type": args.world_position_embedding_type,
            "voxel_size": args.voxel_size,
            "min_xyz_range": args.min_xyz_range,
            "max_xyz_range": args.max_xyz_range,
            "ground_head_type": args.ground_head_type}
    return {k: v for k, v in keys.items() if v is not None}


def _model_cfg(args):
    """ModelConfig from the flags alone (a trainer export has no
    config.json)."""
    from video3d_tpu_torch.config import (GroundHeadType, ModelConfig,
                                          VoxelConfig, World3DConfig)

    w3d = World3DConfig.from_reference_string(
        args.world_position_embedding_type or "avg-discrete-sin3d",
        VoxelConfig(voxel_size=args.voxel_size or 0.1,
                    min_xyz_range=tuple(args.min_xyz_range or (-15, -15, -5)),
                    max_xyz_range=tuple(args.max_xyz_range or (15, 15, 5))))
    return ModelConfig(world_3d=w3d,
                       ground_head=GroundHeadType(args.ground_head_type
                                                  or "infonce"))


def _check_pe(args) -> None:
    pe = args.world_position_embedding_type
    if pe is not None and not any(t in pe for t in PE_KINDS):
        raise SystemExit(
            f"--world-position-embedding-type {pe!r}: expected a reference-"
            "style string containing one of sin3d/mlp/mrope/llava3d/none "
            "(e.g. 'avg-discrete-sin3d')")


def _check_mesh(args) -> None:
    if max(getattr(args, "dp", 1), getattr(args, "tp", 1),
           getattr(args, "sp", 1)) > 1:
        raise NotImplementedError("--dp / --tp / --sp above 1: meshes are "
                                  "not ported (ROADMAP A12)")


def _device(args):
    from video3d_tpu_torch.params import resolve_device

    return resolve_device(args.device)


def _dtype(device):
    import torch

    return torch.bfloat16 if device.type == "cuda" else torch.float32


def _load_model(args, device):
    """(params, ModelConfig) of ``--model-path`` on ``device``, bf16 on the
    card (f32 on the CPU): through the builder when the directory has a
    config.json (its own architecture and 3D knobs, the flags
    overriding), else a trainer export's ``params.pt`` with the flags'
    architecture."""
    import torch

    _check_pe(args)
    path = args.model_path
    if os.path.isfile(os.path.join(path, "config.json")):
        from video3d_tpu_torch.models.builder import load_pretrained_model

        _, params, cfg, _ = load_pretrained_model(
            path, overwrite_config=_overrides(args), dtype=_dtype(device),
            load_tokenizer=False, device=device)
        return params, cfg
    from video3d_tpu_torch.train.checkpoint import PARAMS_FILE

    params = torch.load(os.path.join(path, PARAMS_FILE),
                        map_location=device, weights_only=True)
    return params, _model_cfg(args)


def cmd_train(args) -> None:
    from video3d_tpu_torch.data.dataset import (Collator, CollatorConfig,
                                                SupervisedDataset)
    from video3d_tpu_torch.data.image_processor import SigLipImageProcessor
    from video3d_tpu_torch.train.optim import OptimConfig
    from video3d_tpu_torch.train.trainer import Trainer, TrainingConfig

    if args.bits != 16 and not args.lora_enable:
        raise SystemExit("--bits 8/4 quantizes the FROZEN base and only "
                         "makes sense with --lora-enable (QLoRA); int8 "
                         "weights cannot take optimizer updates")
    _check_mesh(args)
    device = _device(args)
    if args.load_format == "dummy":
        from video3d_tpu_torch.models.builder import load_dummy_model

        _, params, model_cfg = load_dummy_model(
            args.model_path, bits=(args.bits if args.lora_enable else 16),
            overwrite_config=_overrides(args), load_tokenizer=False,
            device=device, dtype=_dtype(device))
    else:
        params, model_cfg = _load_model(args, device)
    tokenizer = _load_tokenizer(args.tokenizer_path or args.model_path)
    tokenizer.add_tokens(["<ground>", "<coord>"], special_tokens=True)
    dataset = SupervisedDataset(
        args.data_path, tokenizer, _data_cfg(args),
        image_processor=SigLipImageProcessor(
            size=(model_cfg.vision.image_size,) * 2))
    collator = Collator(model_cfg, CollatorConfig(
        max_len=args.max_len, frames_upbound=args.max_frame_num,
        coord_token_id=tokenizer.convert_tokens_to_ids("<coord>"),
        ground_token_id=tokenizer.convert_tokens_to_ids("<ground>")))
    steps = len(dataset) * args.num_epochs // max(1, args.global_batch_size)
    # mm_tunable_parts -> tree prefixes (train_3d.py:1758-1829; the world
    # PE and the ground head always train)
    part_map = {"mm_language_model": ("llm",),
                "mm_vision_tower": ("vision",),
                "mm_mlp_adapter": ("projector", "image_newline")}
    tunable = ("ground_head", "world_pe_mlp")
    for part in args.mm_tunable_parts.split(","):
        tunable += part_map.get(part.strip(), ())
    trainer = Trainer(
        model_cfg, params, dataset, collator,
        OptimConfig(learning_rate=args.learning_rate,
                    mm_vision_tower_lr=args.mm_vision_tower_lr,
                    mm_projector_lr=args.mm_projector_lr,
                    warmup_ratio=args.warmup_ratio,
                    total_steps=max(1, steps), tunable_prefixes=tunable),
        TrainingConfig(output_dir=args.output_dir, num_epochs=args.num_epochs,
                       per_device_batch_size=args.per_device_batch_size,
                       gradient_accumulation_steps=(
                           args.gradient_accumulation_steps),
                       save_steps=args.save_steps, group_by=args.group_by,
                       metrics_file=args.metrics_file,
                       master_f32=(args.master_dtype == "float32"),
                       lora_r=(args.lora_r if args.lora_enable else 0),
                       lora_alpha=args.lora_alpha, lora_bits=args.bits),
        device=device)
    trainer.train(resume=not args.no_resume)


def _data_cfg(args):
    from video3d_tpu_torch.config import DataConfig, FrameSampling

    return DataConfig(video_folder=args.video_folder,
                      annotation_dir=args.embodiedscan_folder,
                      metadata_dir=args.metadata_folder,
                      frames_upbound=args.max_frame_num,
                      frame_sampling=FrameSampling(
                          args.frame_sampling_strategy),
                      add_spatial_instruction=getattr(
                          args, "add_spatial_instruction", True))


def cmd_eval(args, task: str) -> None:
    from video3d_tpu_torch.data.video_processor import VideoProcessor
    from video3d_tpu_torch.eval import drivers
    from video3d_tpu_torch.serve.model_worker import weight_bits

    _check_mesh(args)
    device = _device(args)
    bits, act = weight_bits(args)
    if args.load_format == "dummy":
        if args.lora_path:
            raise SystemExit("--load-format dummy has no real base weights "
                             "to merge --lora-path into")
        from video3d_tpu_torch.models.builder import load_dummy_model

        _, params, model_cfg = load_dummy_model(
            args.model_path, bits=bits, act=act,
            overwrite_config=_overrides(args), load_tokenizer=False,
            device=device, dtype=_dtype(device))
    else:
        from video3d_tpu_torch.models.quant import quantize_tree
        from video3d_tpu_torch.train.lora import maybe_merge_lora

        params, model_cfg = _load_model(args, device)
        # a QLoRA export quantizes the base to its bits first; a later
        # --load-in-8bit/4bit then passes the quantized leaves through
        params = maybe_merge_lora(params, args.lora_path)
        if bits != 16:
            params = quantize_tree(params, bits=bits, act=act)
    tokenizer = _load_tokenizer(args.tokenizer_path or args.model_path)
    tokenizer.add_tokens(["<ground>", "<coord>"], special_tokens=True)
    with open(args.question_file) as f:
        questions = json.load(f) if args.question_file.endswith(".json") \
            else [json.loads(line) for line in f]
    questions = questions[args.rank::args.world]
    engine = drivers.InferenceEngine(
        params, model_cfg, tokenizer, VideoProcessor(_data_cfg(args)),
        engine_cfg=drivers.EngineConfig(
            max_new_tokens=args.max_new_tokens,
            eos_token_id=tokenizer.eos_token_id,
            max_frames=args.max_frame_num,
            ground_token_id=tokenizer.convert_tokens_to_ids("<ground>"),
            kv_cache_dtype=args.kv_cache_dtype,
            temperature=args.temperature, top_p=args.top_p,
            top_k=args.top_k, num_beams=args.num_beams,
            length_penalty=args.length_penalty,
            speculative_draft_layers=args.spec_draft_layers,
            speculative_k=args.spec_k,
            speculative_draft_vocab=args.spec_draft_vocab,
            scene_cache_scenes=args.scene_cache,
            prefix_cache_scenes=args.prefix_cache),
        device=device)
    if task == "scan2cap":
        times = drivers.run_generative(
            engine, questions, args.answer_file, gt_from_annotations=True,
            coord_token_id=tokenizer.convert_tokens_to_ids("<coord>"),
            batch_size=args.batch_size)
    elif task in ("scanqa", "sqa3d"):
        times = drivers.run_generative(engine, questions, args.answer_file,
                                       batch_size=args.batch_size)
    elif task == "scanrefer":
        times = drivers.run_scanrefer(engine, questions, args.answer_file,
                                      batch_size=args.batch_size)
    else:
        times = drivers.run_multi3drefer(engine, questions, args.answer_file,
                                         batch_size=args.batch_size)
    print(f"mean inference time: {np.mean(times):.3f}s over {len(times)} "
          f"samples")


def _add_model_args(p) -> None:
    p.add_argument("--world-position-embedding-type", default=None,
                   dest="world_position_embedding_type")
    p.add_argument("--voxel-size", type=float, default=None)
    p.add_argument("--min-xyz-range", type=float, nargs=3, default=None)
    p.add_argument("--max-xyz-range", type=float, nargs=3, default=None)
    p.add_argument("--ground-head-type", default=None)
    p.add_argument("--model-path", required=True,
                   help="HF-format checkpoint dir (config.json + "
                        "safetensors) or a trainer export's model dir")
    p.add_argument("--tokenizer-path", default=None)
    p.add_argument("--device", default=None,
                   help="torch device (default: the first CUDA card; "
                        "without one the CLI raises)")
    p.add_argument("--load-format", choices=("auto", "dummy"),
                   default="auto",
                   help="'dummy' draws random weights on the device from "
                        "config.json alone (vLLM load_format=dummy)")


def _add_data_args(p) -> None:
    p.add_argument("--video-folder", default="data")
    p.add_argument("--embodiedscan-folder", default="data/embodiedscan")
    p.add_argument("--metadata-folder", default="data/metadata")
    p.add_argument("--frame-sampling-strategy", default="uniform")
    p.add_argument("--max-frame-num", type=int, default=32)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser("video3d_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    pt = sub.add_parser("train")
    _add_model_args(pt)
    _add_data_args(pt)
    pt.add_argument("--add-spatial-instruction",
                    dest="add_spatial_instruction", action="store_true",
                    default=True)
    pt.add_argument("--no-spatial-instruction",
                    dest="add_spatial_instruction", action="store_false")
    pt.add_argument("--data-path", required=True)
    pt.add_argument("--output-dir", required=True)
    pt.add_argument("--num-epochs", type=int, default=1)
    pt.add_argument("--per-device-batch-size", type=int, default=1)
    pt.add_argument("--gradient-accumulation-steps", type=int, default=2)
    pt.add_argument("--global-batch-size", type=int, default=16)
    pt.add_argument("--learning-rate", type=float, default=1e-5)
    pt.add_argument("--mm-vision-tower-lr", type=float, default=2e-6)
    pt.add_argument("--mm-projector-lr", type=float, default=None)
    pt.add_argument("--mm-tunable-parts",
                    default="mm_language_model,mm_vision_tower,mm_mlp_adapter")
    pt.add_argument("--metrics-file", default=None)
    pt.add_argument("--warmup-ratio", type=float, default=0.03)
    pt.add_argument("--save-steps", type=int, default=1000)
    pt.add_argument("--group-by", default="task_length")
    pt.add_argument("--max-len", type=int, default=8192)
    pt.add_argument("--master-dtype", default="float32",
                    choices=("float32", "bfloat16"))
    pt.add_argument("--dp", type=int, default=1)
    pt.add_argument("--tp", type=int, default=1)
    pt.add_argument("--sp", type=int, default=1)
    pt.add_argument("--no-resume", action="store_true")
    pt.add_argument("--lora-enable", action="store_true")
    pt.add_argument("--lora-r", type=int, default=128)
    pt.add_argument("--lora-alpha", type=int, default=256)
    pt.add_argument("--bits", type=int, default=16, choices=(16, 8, 4),
                    help="freeze the base in bf16 (16) or quantize it to "
                         "int8/int4 (QLoRA; requires --lora-enable)")

    for task in ("scanqa", "sqa3d", "scan2cap", "scanrefer", "multi3drefer"):
        pe = sub.add_parser(f"eval-{task}")
        _add_model_args(pe)
        _add_data_args(pe)
        pe.add_argument("--question-file", required=True)
        pe.add_argument("--answer-file", required=True)
        pe.add_argument("--rank", type=int, default=0)
        pe.add_argument("--world", type=int, default=1)
        pe.add_argument("--batch-size", type=int, default=1)
        pe.add_argument("--max-new-tokens", type=int, default=512)
        pe.add_argument("--kv-cache-dtype",
                        choices=("bfloat16", "int8", "int4"),
                        default="bfloat16")
        pe.add_argument("--load-in-8bit", action="store_true")
        pe.add_argument("--load-in-4bit", action="store_true")
        pe.add_argument("--lora-path", default=None,
                        help="a trainer's LoRA / QLoRA export (the run's "
                             "model dir; lora.json beside it) to apply to "
                             "the base weights before serving")
        pe.add_argument("--w8a8", action="store_true",
                        help="int8 weights with dynamic int8 activations "
                             "(implies --load-in-8bit)")
        pe.add_argument("--tp", type=int, default=1)
        pe.add_argument("--dp", type=int, default=1)
        pe.add_argument("--temperature", type=float, default=0.0)
        pe.add_argument("--top-p", type=float, default=1.0)
        pe.add_argument("--top-k", type=int, default=0)
        pe.add_argument("--num-beams", type=int, default=1)
        pe.add_argument("--length-penalty", type=float, default=1.0)
        pe.add_argument("--spec-draft-layers", type=int, default=0)
        pe.add_argument("--spec-k", type=int, default=4)
        pe.add_argument("--spec-draft-vocab", type=int, default=0)
        pe.add_argument("--scene-cache", type=int, default=8)
        pe.add_argument("--prefix-cache", type=int, default=4)
    return parser


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    if args.cmd == "train":
        cmd_train(args)
    else:
        cmd_eval(args, args.cmd.removeprefix("eval-"))


if __name__ == "__main__":
    main()
