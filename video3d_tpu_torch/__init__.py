"""video3d_tpu_torch — the PyTorch + CUDA port of ``video3d_tpu`` for one
NVIDIA H100.

Layers (each module mirrors its ``video3d_tpu`` counterpart):
  config.py, constants.py, data/, models/splice.py, train/samplers.py,
  train/prefetch.py
             the port's own copies of the JAX package's host modules
  params.py  random init on the device; conversion of the JAX parameter tree
  ops/       geometry, sin3d position embedding and max-coverage frame
             selection (plain torch)
  kernels/   hand-written CUDA kernel wrappers (source in csrc/), each with
             its plain PyTorch version; CPU tensors take the plain version
  models/    SigLIP tower, Qwen2 decoder, assembly, greedy generation,
             the paged KV pool
  eval/      ScanQA-style InferenceEngine and driver loop
  serve/     the continuous batcher (dense rows or paged, shared prefix
             pages)
  train/     f32-master fine-tuning
  bench/     the benchmark (``python -m video3d_tpu_torch.bench``), the
             flagship modes, dense vs paged decode, the HBM probes

The package imports ``torch`` and never ``jax``, and nothing of
``video3d_tpu`` (``tests/test_torch_imports.py``).
"""
