"""video3d_tpu_torch — the PyTorch + CUDA port of ``video3d_tpu`` for one
NVIDIA H100.

Layers (each module mirrors its ``video3d_tpu`` counterpart):
  config.py  the JAX package's config dataclasses (no JAX in them)
  params.py  random init on the device; conversion of the JAX parameter tree
  ops/       geometry and sin3d position embedding (plain torch)
  kernels/   hand-written CUDA kernel wrappers (source in csrc/), each with
             its plain PyTorch version; CPU tensors take the plain version
  models/    SigLIP tower, Qwen2 decoder, assembly, greedy generation
  eval/      ScanQA-style InferenceEngine and driver loop

The package imports ``torch`` and never ``jax``; host code without JAX is
imported from ``video3d_tpu``.
"""
