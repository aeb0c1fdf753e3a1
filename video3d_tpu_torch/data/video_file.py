"""Real video-file loading (mp4/avi/...): the legacy LLaVA-Video modality.

The reference loads video files with decord / pyav
(llava/utils.py:25-71 ``process_video_with_decord`` /
``process_video_with_pyav``, used by the legacy trainer's video branch,
train.py:1194) — neither library is available here (nor needed): cv2
reproduces the same frame-sampling contract.

Sampling semantics (decord parity):
  * take every ``round(fps / video_fps)``-th frame (default 1 frame/s);
  * if that exceeds ``frames_upbound`` (or ``force_sample``), resample to
    exactly ``frames_upbound`` uniformly over the whole clip
    (``np.linspace(0, total-1, upbound)``);
  * report per-frame timestamps and total duration for the optional
    time instruction (train_3d.py:1258-1260).

The port's own copy of ``video3d_tpu/data/video_file.py`` (the port imports
nothing of the JAX package); cv2 is imported where a file is read.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def load_video_file(path: str, video_fps: int = 1, frames_upbound: int = 0,
                    force_sample: bool = False
                    ) -> Tuple[np.ndarray, float, str, int]:
    """Returns (frames (N, H, W, 3) RGB uint8, video_time_seconds,
    frame_time string "0.00s,1.00s,...", num_frames)."""
    import cv2

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise FileNotFoundError(f"cannot open video file: {path}")
    try:
        fps = cap.get(cv2.CAP_PROP_FPS) or 1.0
        total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        video_time = total / fps
        step = max(1, round(fps / max(video_fps, 1)))
        frame_idx = list(range(0, total, step))
        frame_time = [i / step for i in frame_idx]
        if frames_upbound > 0 and (len(frame_idx) > frames_upbound
                                   or force_sample):
            frame_idx = np.linspace(0, total - 1, frames_upbound,
                                    dtype=int).tolist()
            frame_time = [i / fps for i in frame_idx]
        frames = []
        for idx in frame_idx:
            cap.set(cv2.CAP_PROP_POS_FRAMES, idx)
            ok, frame = cap.read()
            if not ok:
                raise IOError(f"failed to read frame {idx} of {path}")
            frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
    finally:
        cap.release()
    frame_time_str = ",".join(f"{t:.2f}s" for t in frame_time)
    return np.stack(frames), video_time, frame_time_str, len(frame_idx)


def time_instruction(video_time: float, num_frames: int,
                     frame_time: str) -> str:
    """The exact add_time_instruction prompt text (train_3d.py:1259)."""
    return (f"The video lasts for {video_time:.2f} seconds, and "
            f"{num_frames} frames are uniformly sampled from it. These "
            f"frames are located at {frame_time}.Please answer the "
            f"following questions related to this video.")
