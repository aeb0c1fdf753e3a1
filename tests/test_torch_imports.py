"""The port imports nothing of JAX and nothing of the JAX package: every
module of ``video3d_tpu_torch``, and ``chip_smoke`` (imported, not run), in
a fresh interpreter leave no ``jax*`` and no ``video3d_tpu`` /
``video3d_tpu.*`` key in ``sys.modules``."""

import os
import pkgutil
import subprocess
import sys
import textwrap

import video3d_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        video3d_tpu_torch.__path__, "video3d_tpu_torch."))


def test_port_modules_are_listed():
    mods = _port_modules()
    for name in ("video3d_tpu_torch.config", "video3d_tpu_torch.data.dataset",
                 "video3d_tpu_torch.eval.drivers",
                 "video3d_tpu_torch.train.trainer",
                 "video3d_tpu_torch.serve.batcher",
                 "video3d_tpu_torch.models.paged_kv",
                 "video3d_tpu_torch.kernels.paged_attention",
                 "video3d_tpu_torch.kernels.stream_probe",
                 "video3d_tpu_torch.ops.mc_select",
                 "video3d_tpu_torch.bench.__main__",
                 "video3d_tpu_torch.bench.flagship",
                 "video3d_tpu_torch.bench.grounding",
                 "video3d_tpu_torch.eval.protocols",
                 "video3d_tpu_torch.eval.metrics.meteor15",
                 "video3d_tpu_torch.ops.box",
                 "video3d_tpu_torch.data.anyres",
                 "video3d_tpu_torch.data.video_file",
                 "video3d_tpu_torch.models.anyres",
                 "video3d_tpu_torch.eval.interleave",
                 "video3d_tpu_torch.serve.controller",
                 "video3d_tpu_torch.serve.model_worker",
                 "video3d_tpu_torch.serve.router",
                 "video3d_tpu_torch.serve.register_worker",
                 "video3d_tpu_torch.serve.cli",
                 "video3d_tpu_torch.serve.web"):
        assert name in mods


def test_port_and_chip_smoke_import_no_jax_package():
    script = textwrap.dedent(f"""
        import importlib, sys
        sys.path[:0] = [{REPO!r}]
        for name in {_port_modules()!r} + ["chip_smoke"]:
            importlib.import_module(name)
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] == "video3d_tpu"
                     or m.split(".")[0].startswith("jax"))
        assert not bad, bad
        print("OK")
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=300, env=env, cwd=REPO)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().endswith("OK")
