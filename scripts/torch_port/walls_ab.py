"""A/B of ``chip_smoke.py``'s host-paced walls between source trees, on one
CUDA GPU: phase 5 (the scene-prefix path: a miss chunk, a B=8 hit chunk
and a B=1 hit) and phase 8 (the paged batcher's output tokens/s), with
bf16 weights and cache, then with int8 weights and an int8 cache.

    python3 scripts/torch_port/walls_ab.py --parent DIR [--turns 10]

DIR holds another tree (for example an unpacked ``git archive`` of the
parent commit under the git-ignored ``.rehearsal/``). Each turn is a fresh
process that imports one tree's ``chip_smoke`` and ``video3d_tpu_torch``,
builds its kernels and runs both phases on two synthetic 32-frame scenes;
the turns go parent, change, change, parent, parent, change, ... Prints
each turn's figures as it ends, then the medians of each side.
"""

from __future__ import annotations

import argparse
import gc
import os
import re
import statistics
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
FIGURES = (("miss chunk s", r"miss chunk ([0-9.]+)"),
           ("hit chunk s", r"hit chunk ([0-9.]+)"),
           ("B=1 hit s", r"B=1 hit ([0-9.]+); wall"),
           ("serving tokens/s", r"= ([0-9.]+) tokens/s over all slots"))


def turn(tree: str) -> None:
    """One turn: phases 5 and 8 of ``tree``'s chip_smoke, bf16 then int8."""
    sys.path[:0] = [tree, os.path.join(tree, "tests")]
    os.chdir(tree)
    import chip_smoke as cs

    cs.preconditions()
    cs.build()
    import torch
    from fixtures import make_fake_scene

    from video3d_tpu_torch.config import ModelConfig
    from video3d_tpu_torch.params import init_model

    cfg = ModelConfig()
    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory() as root:
        infos = [make_fake_scene(root, scene_id=f"scene{i:04d}_00",
                                 n_frames=32, H=480, W=640, extend=i > 0)
                 for i in range(2)]
        for bits, kv, atol in ((16, "bfloat16", cs.LOGIT_ATOL),
                               (8, "int8", cs.INT8_LOGIT_ATOL)):
            params = init_model(cfg, dev,
                                torch.Generator(device=dev).manual_seed(0),
                                torch.bfloat16, bits=bits)
            print(f"== {kv}", flush=True)
            cs.run_prefix_path(params, cfg, root, infos[0],
                               kv_cache_dtype=kv, logit_atol=atol)
            cs.run_serving(params, cfg, root, infos, kv_cache_dtype=kv)
            del params
            gc.collect()
            torch.cuda.empty_cache()


def figures(log: str) -> dict:
    """{(config, figure): value} from a turn's output."""
    out = {}
    for part in log.split("== ")[1:]:
        kv = part.split("\n", 1)[0].strip()
        for name, pat in FIGURES:
            m = re.search(pat, part)
            if m:
                out[(kv, name)] = float(m.group(1))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="the other tree")
    ap.add_argument("--turns", type=int, default=10)
    ap.add_argument("--turn", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.turn:
        turn(os.path.abspath(a.turn))
        return
    trees = {"parent": os.path.abspath(a.parent), "change": ROOT}
    order = [("parent", "change", "change", "parent")[i % 4]
             for i in range(a.turns)]
    seen = {"parent": [], "change": []}
    for i, side in enumerate(order, 1):
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--turn", trees[side]], capture_output=True,
                             text=True)
        if res.returncode != 0:
            raise SystemExit(f"walls_ab: turn {i} ({side}) failed:\n"
                             f"{res.stdout[-4000:]}{res.stderr[-4000:]}")
        figs = figures(res.stdout)
        seen[side].append(figs)
        print(f"turn {i} {side}: "
              f"{ {f'{k[0]} {k[1]}': v for k, v in figs.items()} }",
              flush=True)
    for key in sorted({k for runs in seen.values() for r in runs for k in r}):
        med = {side: statistics.median(r[key] for r in runs)
               for side, runs in seen.items() if runs}
        print(f"{key[0]} {key[1]}: median change {med.get('change')}, "
              f"parent {med.get('parent')}", flush=True)


if __name__ == "__main__":
    main()
