"""Interactive serving CLI (reference llava/serve/cli.py equivalent):
talks to a controller (or directly to a worker) over HTTP.

``--message`` sends ONE message and exits — the reference's smoke-test
client (llava/serve/test_message.py:9-47: list models, resolve a worker
through the controller, send a single generate request, print the text).
"""

from __future__ import annotations

import argparse

from video3d_tpu_torch.serve.controller import _post_json


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--controller", default="http://127.0.0.1:21001")
    parser.add_argument("--model", default="video3d-qwen2-7b")
    parser.add_argument("--video", default=None, help="e.g. scannet/scene0000_00")
    parser.add_argument("--image", action="append", default=[],
                        help="2D multi-image chat instead of a 3D scene: "
                             "a local image file, repeatable — each is "
                             "base64-encoded into the worker's 'images' "
                             "wire field (one '<image>' sentinel per "
                             "file; mutually exclusive with --video)")
    parser.add_argument("--max-new-tokens", type=int, default=512)
    parser.add_argument("--message", default=None,
                        help="one-shot: send this message, print the reply, "
                             "exit (test_message.py equivalent)")
    args = parser.parse_args(argv)
    if bool(args.video) == bool(args.image):
        parser.error("exactly one of --video (3D scene) or --image "
                     "(2D chat) is required")
    images = None
    if args.image:
        import base64

        images = [base64.b64encode(open(p, "rb").read()).decode()
                  for p in args.image]

    print(f"models: {_post_json(args.controller + '/list_models', {})['models']}")
    if args.message is not None:
        # Resolve ONCE and post straight to that worker (the reference
        # test_message.py:20-33 flow). Routing through the controller's
        # /worker_generate proxy here would dispatch AGAIN — the printed
        # address could differ from the worker actually used under
        # shortest_queue, and each one-shot would double-increment
        # queue_length until the next heartbeat.
        addr = _post_json(args.controller + "/get_worker_address",
                          {"model": args.model,
                           "video": args.video or ""})["address"]
        print(f"worker_addr: {addr}")
        # 2D mode sends the bare message: the engine prepends one
        # '<image>' sentinel per attached image itself
        value = (args.message if images
                 else f"<image>\n{args.message}")
        wire = {"model": args.model,
                "conversations": [
                    {"from": "human", "value": value},
                    {"from": "gpt", "value": None}],
                "max_new_tokens": args.max_new_tokens}
        if images:
            wire["images"] = images
        else:
            wire["video"] = args.video
        out = _post_json(addr + "/worker_generate", wire, timeout=600)
        print(out.get("text", out))
        return 0 if out.get("error_code", 0) == 0 else 1
    # multi-turn: accumulate the conversation client-side and re-prompt
    # with the full history (the reference cli.py conversation loop,
    # llava/serve/cli.py:58-86, as a stateless wire field)
    history = []
    while True:
        try:
            prompt = input("user> ").strip()
        except EOFError:
            break
        if not prompt:
            continue
        if prompt in (":reset", ":clear"):
            history = []
            print("(history cleared)")
            continue
        turn = prompt if (history or images) else f"<image>\n{prompt}"
        history.append({"from": "human", "value": turn})
        wire = {"model": args.model,
                "conversations": history + [{"from": "gpt", "value": None}],
                "max_new_tokens": args.max_new_tokens}
        if images:
            # the worker re-templates the FULL conversation each round
            # (generate_answer_images(conversations=...)), so history
            # accumulates exactly like the 3D path
            wire["images"] = images
        else:
            wire["video"] = args.video
        try:
            out = _post_json(args.controller + "/worker_generate", wire,
                             timeout=600)
        except Exception as e:  # noqa: BLE001 — worker/controller down
            out = {"text": "", "error": str(e), "error_code": 1}
        text = out.get("text", "")
        if out.get("error_code", 0) == 0 and text:
            print(f"assistant> {text}")
            history.append({"from": "gpt", "value": text})
        else:
            # keep the history well-formed: drop the failed turn (an
            # empty gpt value would render as a stray generation header
            # mid-prompt on the next round)
            history.pop()
            print(f"assistant> (error) {out.get('error', out)}")


if __name__ == "__main__":
    main()
