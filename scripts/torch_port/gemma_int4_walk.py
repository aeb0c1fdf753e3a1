"""Layer walk of the first step over an int4 KV cache: LLaVA over Gemma-2B
(head_dim 256, the hd-256 kernel's int4 form) against Qwen2-7B's
(``ModelConfig()``, the hd-128 kernels' int4 form), on a machine with one
CUDA card:

    python3 scripts/torch_port/gemma_int4_walk.py

Each model (bf16, seeded random weights, full width and depth) answers one
question on a 32-frame synthetic scene through a prefix-caching engine with
``kv_cache_dtype="int4"`` (the miss stores the scene prefix as int4), then a
second question hits the stored prefix: its suffix's first step
(``generate.start_decode_prefix``, B2 folded over the int4 cache in every
layer) runs three times, with each decoder layer's output recorded:

* through the kernel;
* with the int4 forms' plain versions in f32 swapped in (as chip_smoke's
  ``_plain_quant_forms`` does), the reference;
* with a plain version that rounds p x value scale to bf16 before the PV
  product, as the kernels and the TPU kernel do
  (``video3d_tpu/kernels/decode_attention.py:105-117``), ``rounded``.

Per layer it prints max |kernel - reference| over the suffix rows relative
to max |reference| (the gap), the same of ``rounded``, and of the kernel
against ``rounded``; then the first Gemma-2B layer whose gap exceeds the
largest gap of any Qwen2-7B layer, and the first-step logits' gaps. Where
the kernel lies far closer to ``rounded`` than to the reference, the
rounding accounts for the gap. Writes ``chiprun_out/gemma_int4_walk.json``.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import chip_smoke as cs  # noqa: E402


def folded_rounded(q, k_all, v_all, lengths, q_offsets, layer, kv_heads,
                   k_scale, v_scale):
    """B2 folded over a quantized cache layer in f32, except that p (the
    unnormalised softmax weight) times the value scale is rounded to bf16
    before the product with the raw values, and l sums the unrounded p."""
    import torch

    from video3d_tpu_torch.kernels.decode_attention import layer_kv

    B, L, H, hd = q.shape
    G = H // kv_heads
    kl, vl = layer_kv(q.float(), k_all, v_all, layer, kv_heads)   # raw
    ks, vs = k_scale[layer].float(), v_scale[layer].float()        # (B,S,KV,1)
    S = kl.shape[1]
    k = (kl * ks).repeat_interleave(G, dim=2)
    v = vl.repeat_interleave(G, dim=2)
    vsc = vs[..., 0].repeat_interleave(G, dim=2)                   # (B,S,H)
    pos = q_offsets.long()[:, None] + torch.arange(L, device=q.device)
    keys = torch.arange(S, device=q.device)
    allow = (keys[None, None] <= pos[..., None]) \
        & (keys[None, None] < lengths.long()[:, None, None])       # (B,L,S)
    s = torch.einsum("blhd,bshd->bhls", q.float(), k) * hd ** -0.5
    s = s.masked_fill(~allow[:, None], -torch.inf)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m).nan_to_num(0.0)
    l = p.sum(-1, keepdim=True)
    pv = (p * vsc.permute(0, 2, 1)[:, :, None]).to(torch.bfloat16).float()
    out = torch.einsum("bhls,bshd->blhd", pv, v) / l.permute(0, 2, 1, 3)
    return out.to(q.dtype)


@contextlib.contextmanager
def _rounded_folded():
    """Swap B2 folded over an int4 cache for :func:`folded_rounded`."""
    import torch

    from video3d_tpu_torch.kernels import flash_attention as fa

    kernel = fa.flash_attention_gqa_folded

    def fn(q, k_all, v_all, *args, **kwargs):
        if k_all.dtype != torch.uint8:
            return kernel(q, k_all, v_all, *args, **kwargs)
        return folded_rounded(q, k_all, v_all, *args, **kwargs)
    fa.flash_attention_gqa_folded = fn
    try:
        yield
    finally:
        fa.flash_attention_gqa_folded = kernel


def _recorded_step(params, cfg, engine, hit):
    """The hit's first step: (each decoder layer's output on the suffix
    rows, the first-step logits), both f32."""
    import torch

    from video3d_tpu_torch.models import generate as gen
    from video3d_tpu_torch.models import qwen2

    layers = []
    layer_fn = qwen2.decoder_layer

    def recorder(*args, **kwargs):
        x = layer_fn(*args, **kwargs)
        layers.append(x.float().clone())
        return x
    qwen2.decoder_layer = recorder
    try:
        with torch.inference_mode():
            state = gen.start_decode_prefix(
                params, cfg, hit["batch"], hit["entry"].cache,
                hit["entry"].prefix_len, hit["bucket"] + cs.MAX_NEW,
                engine.cache_dtype)
            logits = state.next_logits.float().clone()
    finally:
        qwen2.decoder_layer = layer_fn
    del state
    torch.cuda.empty_cache()
    n = int(hit["batch"].seq_len[0]) - hit["entry"].prefix_len
    return [x[:, :n] for x in layers], logits


def _gap(a, ref) -> float:
    return float((a - ref).abs().max()) / float(ref.abs().max())


def walk(name: str, params, cfg, root: str, info) -> dict:
    """Per-layer gaps of one model's int4 prefix hit (see the module
    docstring)."""
    engine = cs._make_engine(params, cfg, root, prefix_cache_scenes=1,
                             kv_cache_dtype="int4")
    miss = cs._questions(info["sample_idx"], cs.SCANQA_TEXTS[:1], name)[0]
    engine.generate_answer(miss)
    hit_q = cs._questions(info["sample_idx"], cs.PREFIX_TEXTS[:1],
                          f"{name}_hit")[0]
    hit = engine.prepare_request(hit_q)
    if hit["mode"] != "prefix":
        raise SystemExit(f"{name}: the question did not hit the int4 prefix "
                         f"({hit['mode']})")
    got, got_logits = _recorded_step(params, cfg, engine, hit)
    with cs._plain_quant_forms(storage="uint8"):
        ref, ref_logits = _recorded_step(params, cfg, engine, hit)
    with _rounded_folded():
        rnd, rnd_logits = _recorded_step(params, cfg, engine, hit)
    rows = [{"layer": i, "kernel": _gap(a, r), "rounded": _gap(c, r),
             "kernel_vs_rounded": _gap(a, c),
             "max_abs_ref": float(r.abs().max())}
            for i, (a, r, c) in enumerate(zip(got, ref, rnd))]
    logits = {"kernel": float((got_logits - ref_logits).abs().max()),
              "rounded": float((rnd_logits - ref_logits).abs().max()),
              "kernel_vs_rounded": float((got_logits - rnd_logits).abs()
                                         .max()),
              "max_abs_ref": float(ref_logits.abs().max())}
    print(f"{name}: {len(rows)} layers, suffix of {got[0].shape[1]} rows "
          f"over a prefix of {hit['entry'].prefix_len}", flush=True)
    for r in rows:
        print(f"  layer {r['layer']:2d}: kernel {r['kernel']:.3e}, rounded "
              f"{r['rounded']:.3e}, kernel vs rounded "
              f"{r['kernel_vs_rounded']:.3e} (max |ref| "
              f"{r['max_abs_ref']:.1f})", flush=True)
    print(f"  first-step logits max |d|: kernel {logits['kernel']:.4f}, "
          f"rounded {logits['rounded']:.4f}, kernel vs rounded "
          f"{logits['kernel_vs_rounded']:.4f} (max |ref| "
          f"{logits['max_abs_ref']:.2f})", flush=True)
    del engine
    return {"layers": rows, "logits": logits}


def main() -> None:
    cs.preconditions()
    import torch

    from fixtures import make_fake_scene

    from video3d_tpu_torch.config import ModelConfig
    from video3d_tpu_torch.params import init_model

    cs.build()
    dev = torch.device("cuda", 0)
    out = {"card": cs._card()}
    with tempfile.TemporaryDirectory() as root:
        info = make_fake_scene(root, scene_id="scene0000_00", n_frames=32,
                               H=480, W=640)
        cfg = ModelConfig()
        params = init_model(cfg, dev, torch.Generator(device=dev)
                            .manual_seed(16), torch.bfloat16)
        out["qwen2_7b_hd128"] = walk("qwen2-7b", params, cfg, root, info)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        cfg = cs._family_config(cs.GEMMA_2B_HF)
        params = cs._family_model("Gemma-2B", cfg, 192)
        out["gemma_2b_hd256"] = walk("gemma-2b", params, cfg, root, info)
    limit = max(r["kernel"] for r in out["qwen2_7b_hd128"]["layers"])
    first = next((r for r in out["gemma_2b_hd256"]["layers"]
                  if r["kernel"] > limit), None)
    out["hd128_largest_layer_gap"] = limit
    out["first_gemma_layer_above"] = first
    print(f"the hd-128 int4 walk's largest layer gap: {limit:.3e}; "
          + ("no Gemma-2B layer exceeds it" if first is None else
             f"Gemma-2B's first layer above it: layer {first['layer']}, gap "
             f"{first['kernel']:.3e} (rounded {first['rounded']:.3e}, "
             f"kernel vs rounded {first['kernel_vs_rounded']:.3e})")
          + f"; {out['card']}", flush=True)
    os.makedirs(cs.OUT_DIR, exist_ok=True)
    with open(os.path.join(cs.OUT_DIR, "gemma_int4_walk.json"), "w") as f:
        json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
