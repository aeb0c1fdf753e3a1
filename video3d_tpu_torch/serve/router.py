"""Cache-length pool routing for the continuous batcher of the PyTorch
port (counterpart of ``video3d_tpu/serve/router.py``).

A single S-slot batcher sizes every cache row for the WORST-case request
(max bucket + budget): at 28 layers x 32k tokens that is ~1.9 GB per slot
— a few long rows exhaust HBM that could hold many short ones. The
static-shape answer (no paging): run several ContinuousBatcher pools with
different row lengths and route each request to the smallest pool it fits,
estimated from the tokenized prompt + frame budget BEFORE any video
loading (cheap: text tokenization only).

Each pool keeps its own scheduler thread, decode state and captured decode
chunks; the card serializes their steps, so pools time-share it in
proportion to their active load.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

from video3d_tpu_torch.serve.batcher import BatchedRequest, ContinuousBatcher


class RoutedBatcher:
    """Routes requests over ContinuousBatcher pools by prompt footprint.

    Args:
      engine: shared InferenceEngine.
      pools: ((max_cache_len, num_slots), ...) sorted or not — routed
        smallest-fit-first. A request whose full footprint (bucket +
        budget) fits no pool goes to the largest one with its budget
        clamped by admission; a request whose PROMPT BUCKET alone exceeds
        the largest pool is failed at submit with a clear error.
      kwargs: forwarded to every ContinuousBatcher (chunk, draft_params...).
    """

    def __init__(self, engine, pools: Sequence[Tuple[int, int]] = (
            (4096, 6), (16384, 2)), **kwargs):
        self.engine = engine
        cfgs = sorted(pools)
        self.pools = [ContinuousBatcher(engine, num_slots=s,
                                        max_cache_len=L, **kwargs)
                      for L, s in cfgs]
        self.limits = [L for L, _ in cfgs]

    def _footprint(self, record) -> int:
        """Upper bound on the request's cache need: the prefill BUCKET the
        engine will pick (tokenized text + full frame budget, padded to the
        bucket grid like _build_batch) + the generation budget. Text
        tokenization only — no video IO."""
        from video3d_tpu_torch.eval.drivers import pick_bucket

        eng = self.engine
        # the engine's own prompt tokenization (drivers.py _tokenize_prompt)
        # — routing always uses the same template family generation will
        ids = eng._tokenize_prompt(record)
        total = len(ids) + eng.ecfg.max_frames * eng.cfg.tokens_per_frame
        bucket = pick_bucket(total + eng.ecfg.max_new_tokens,
                             eng.ecfg.buckets)
        return bucket + eng.ecfg.max_new_tokens, bucket

    def submit(self, record, **kw) -> BatchedRequest:
        need, bucket = self._footprint(record)
        for limit, pool in zip(self.limits, self.pools):
            if need <= limit:
                return pool.submit(record, **kw)
        if bucket < self.limits[-1]:
            # full budget doesn't fit anywhere: largest pool, clamped budget
            return self.pools[-1].submit(record, **kw)
        req = BatchedRequest(record, None, None, 0)
        req.error = ValueError(
            f"prompt bucket {bucket} exceeds the largest pool's cache rows "
            f"({self.limits[-1]}); configure a bigger pool")
        req._q.put(BatchedRequest._DONE)
        return req

    def generate(self, record, **kw) -> str:
        return self.submit(record, **kw).result(self.engine._decode_text)

    def generate_stream(self, record, **kw):
        return self.submit(record, **kw).text_stream(self.engine._decode_text)

    def shutdown(self):
        for pool in self.pools:
            pool.shutdown()
