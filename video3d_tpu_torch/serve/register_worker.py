"""Manually (re-)register a worker with a running controller.

Reference: llava/serve/register_worker.py:1-26 — posts
``{worker_name, check_heart_beat, worker_status: None}`` to the
controller's ``/register_worker``. With ``worker_status=None`` the
controller records the worker with an empty model list; a follow-up
``/refresh_all_workers`` (or the worker's next heartbeat) fills in its
real status. ``--refresh`` issues that refresh immediately (beyond the
reference, which leaves the registry stale until the next heartbeat).
"""

from __future__ import annotations

import argparse

from video3d_tpu_torch.serve.controller import _post_json


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--controller-address", required=True,
                        help="e.g. http://localhost:21001")
    parser.add_argument("--worker-name", required=True,
                        help="worker base URL, e.g. http://localhost:21002")
    parser.add_argument("--check-heart-beat", action="store_true")
    parser.add_argument("--refresh", action="store_true",
                        help="ask the controller to pull the worker's real "
                             "status (models/queue) right away")
    args = parser.parse_args(argv)

    out = _post_json(args.controller_address + "/register_worker", {
        "worker_name": args.worker_name,
        "check_heart_beat": args.check_heart_beat,
        "worker_status": None,
    })
    if args.refresh:
        _post_json(args.controller_address + "/refresh_all_workers", {})
    print(f"registered {args.worker_name}: {out}")
    return 0 if out.get("exist") else 1


if __name__ == "__main__":
    raise SystemExit(main())
