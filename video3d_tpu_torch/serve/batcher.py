"""Continuous batching over one InferenceEngine, in PyTorch: counterpart of
``video3d_tpu/serve/batcher.py`` (greedy, dense rows or the paged KV cache,
with scene-prefix page sharing).

The batcher keeps one persistent S-slot decode state and one scheduler
thread that alternates between admitting pending requests into free slots
and one decode chunk for every slot:

  * slots are rows of the state. Dense rows give every slot a
    ``max_cache_len`` cache row; ``paged=True`` gives the slots a shared
    page pool (``models/paged_kv.py``, read by kernel B7) from which each
    request reserves only its own prompt + budget footprint;
  * admission is a B=1 prefill (``engine.start_request``, or
    ``start_decode``) copied into a free slot (``insert_decode_slot`` /
    ``insert_paged_slot``);
  * on the card the decode chunk is a replayed CUDA graph over the state's
    own tensors (``models/decode_graph.py``), so admission and release
    write what the graph reads; ``toks.tolist()`` is the chunk's one host
    sync;
  * completion or cancellation releases the slot (``release_*_slot``: the
    row decodes EOS until reused) and, paged, returns its pages;
  * with the engine's scene-prefix cache on, paged mode writes each scene's
    full prefix pages into the pool once and every admission on the scene
    references them in its table row instead of a private copy.

Preprocessing (tokenization, video IO, geometry, the tower on a scene-cache
miss) runs on a small thread pool, off the scheduler thread. Answers equal
the sequential engine's: prefill is per request, and the decode rows are
independent.

Not ported: speculative decoding (``draft_params``, the engine's
self-draft; ROADMAP A8), Sarathi-style chunked prefill
(``chunked_prefill``; ROADMAP A4), sampling (A4 / A8; the batcher is
greedy), and the scan2cap inputs ``box_input`` / ``coord_token_id``
(ROADMAP A5). Each raises.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import torch

from video3d_tpu_torch.models.decode_graph import DecodeGraphs
from video3d_tpu_torch.models.generate import (decode_chunk,
                                               empty_decode_state,
                                               empty_paged_state,
                                               insert_decode_slot,
                                               insert_paged_slot,
                                               paged_decode_chunk,
                                               release_decode_slot,
                                               release_paged_slot,
                                               start_decode,
                                               write_shared_prefix)
from video3d_tpu_torch.models.paged_kv import PageAllocator, pages_needed


class BatchedRequest:
    """Handle returned by :meth:`ContinuousBatcher.submit`."""

    _DONE = object()

    def __init__(self, record, max_new_tokens: int):
        self.record = record
        self.max_new_tokens = max_new_tokens
        self._q: "queue.Queue" = queue.Queue()
        self.tokens: list = []
        self.error: Optional[Exception] = None
        self.cancelled = threading.Event()

    def cancel(self) -> None:
        """Release the request at the next scheduler boundary: an in-flight
        slot is finished (pages freed, its row decodes EOS), a queued or
        deferred admission is dropped before it takes a slot. Idempotent;
        safe after completion."""
        self.cancelled.set()

    def text_stream(self, decode_fn):
        """Yield the cumulative text after every delivered batch of
        tokens."""
        while True:
            item = self._q.get()
            if item is self._DONE:
                if self.error is not None:
                    raise self.error
                return
            yield decode_fn(self.tokens)

    def result(self, decode_fn, timeout: Optional[float] = None) -> str:
        while True:
            item = self._q.get(timeout=timeout)
            if item is self._DONE:
                if self.error is not None:
                    raise self.error
                return decode_fn(self.tokens)


class ContinuousBatcher:
    """S-slot continuous batching scheduler over one InferenceEngine
    (JAX ``serve/batcher.py:93-273``).

    Args:
      engine: the InferenceEngine whose parameters, configuration, device
        and preprocessing to use.
      num_slots: requests decoded together per step.
      chunk: decode steps per scheduler iteration: the streaming
        granularity and the bound on admission latency.
      max_cache_len: per-request cache length; default the engine's largest
        prefill bucket + max_new_tokens.
      paged: the paged KV cache instead of dense rows. Each admission
        reserves prompt bucket + its own max_new_tokens + chunk positions
        of pages; an admission that finds too few free pages waits in a
        FIFO until running requests release theirs.
      page_size: tokens per page.
      total_pages: pool size; default 1 + num_slots * ceil((max_cache_len
        + chunk) / page_size), the dense-equivalent worst case (page 0 is
        the scratch page).
      share_prefix_pages: with the engine's scene-prefix cache on
        (``EngineConfig.prefix_cache_scenes``), reference each scene's full
        prefix pages from one pool copy instead of a private copy per
        admission. The pages are held while the engine's LRU keeps the
        scene (its eviction hook) or any slot references them.
      draft_params, draft_cfg, chunked_prefill: speculative decoding and
        chunked prefill, not ported; anything but the defaults raises.
    """

    _DEFER = object()

    def __init__(self, engine, num_slots: int = 4, chunk: int = 8,
                 max_cache_len: Optional[int] = None,
                 draft_params=None, draft_cfg=None,
                 paged: bool = False, page_size: int = 128,
                 total_pages: Optional[int] = None,
                 share_prefix_pages: bool = True,
                 chunked_prefill: int = 0):
        if draft_params is not None or draft_cfg is not None:
            raise NotImplementedError("speculative decoding is not ported "
                                      "(ROADMAP A8)")
        if chunked_prefill > 0:
            raise NotImplementedError("chunked prefill is not ported "
                                      "(ROADMAP A4)")
        self.engine = engine
        self.num_slots = num_slots
        self.chunk = chunk
        ecfg = engine.ecfg
        self.max_cache_len = max_cache_len or (max(ecfg.buckets)
                                               + ecfg.max_new_tokens)
        self.paged = paged
        if paged:
            # each admission reserves its whole footprint (prompt bucket +
            # max_new_tokens + the chunk's overshoot), so a chunk never runs
            # out of pages mid-flight
            self.page_size = page_size
            self.max_pages = -(-(self.max_cache_len + chunk) // page_size)
            self.total_pages = total_pages or 1 + num_slots * self.max_pages
            self.share_prefix = bool(share_prefix_pages)
            # key -> {pages, refs, dead, sig}; refs = live slots + 1 cache
            # hold, dropped when the engine's LRU evicts the scene (hook ->
            # _evicted_keys, drained on the scheduler thread, so all page
            # accounting is single-threaded)
            self._evicted_keys: "queue.Queue" = queue.Queue()
            self._evict_hook = self._evicted_keys.put
            if self.share_prefix:
                engine._prefix_evict_hooks.append(self._evict_hook)
            self.prefix_share_stats = [0, 0]   # [shared admits, creations]
            self._deferred: list = []   # admissions awaiting free pages
        self._reset_state()
        self.slots: list = [None] * num_slots      # BatchedRequest or None
        self.emitted = [0] * num_slots
        self._pending: "queue.Queue" = queue.Queue()
        self._wake = threading.Event()
        self._stop = threading.Event()
        # guards slots / emitted / state: the loop holds it around its
        # admit and emission phases (not across the decode chunk), and
        # shutdown() takes it before failing in-flight requests
        self._lock = threading.Lock()
        self._prep = ThreadPoolExecutor(max_workers=2,
                                        thread_name_prefix="batcher-prep")
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _reset_state(self) -> None:
        """An all-done state (and, paged, an empty pool), and on the card a
        new holder for the decode chunk's graphs: the old state's graphs go
        with it and never replay."""
        eng = self.engine
        self._graphs = (DecodeGraphs(eng.device)
                        if eng.device.type == "cuda" else None)
        if self.paged:
            self.state = empty_paged_state(
                eng.cfg, self.num_slots, self.total_pages, self.page_size,
                self.max_pages, cache_dtype=eng.cache_dtype,
                device=eng.device)
            self._alloc = PageAllocator(self.total_pages)
            self._slot_pages: list = [None] * self.num_slots
            self._shared: dict = {}
            self._slot_shared: list = [None] * self.num_slots
        else:
            self.state = empty_decode_state(
                eng.cfg, self.num_slots, self.max_cache_len,
                cache_dtype=eng.cache_dtype, device=eng.device)

    # ------------- public API -------------

    def submit(self, record, box_input=None, coord_token_id=None,
               max_new_tokens: Optional[int] = None) -> BatchedRequest:
        """Queue a record; its preprocessing runs on the prep pool (JAX
        :277)."""
        if box_input is not None or coord_token_id is not None:
            raise NotImplementedError("box inputs (scan2cap) are not ported "
                                      "(ROADMAP A5)")
        req = BatchedRequest(
            record, self.engine.ecfg.max_new_tokens if max_new_tokens is None
            else max(0, int(max_new_tokens)))   # 0 is a valid budget

        def prepare():
            try:
                eng = self.engine
                if eng._prefix_cache_on(req.record):
                    # scene-prefix path: a hit skips video IO, geometry and
                    # the tower here and most of the prefill in _admit
                    prepared = eng.prepare_request(req.record)
                else:
                    prepared = eng._prepare_generation(req.record)
                if self._stop.is_set():
                    raise RuntimeError("batcher shut down")
                self._pending.put((req, prepared))
            except Exception as e:  # noqa: BLE001
                req.error = e
                req._q.put(BatchedRequest._DONE)
            self._wake.set()

        self._prep.submit(prepare)
        return req

    def generate(self, record, **kw) -> str:
        return self.submit(record, **kw).result(self.engine._decode_text)

    def generate_stream(self, record, **kw):
        return self.submit(record, **kw).text_stream(self.engine._decode_text)

    def shutdown(self):
        """Stop the scheduler and fail every request still waiting
        (JAX :319)."""
        self._stop.set()
        self._wake.set()
        if self.paged and self.share_prefix:
            try:
                self.engine._prefix_evict_hooks.remove(self._evict_hook)
            except ValueError:
                pass
        self._thread.join(timeout=30)
        self._prep.shutdown(wait=False, cancel_futures=True)
        # fail everything still waiting so result() / text_stream() callers
        # never hang on a stopped batcher
        err = RuntimeError("batcher shut down")
        with self._lock:
            for s in range(self.num_slots):
                req = self.slots[s]
                if req is not None:
                    self.slots[s] = None
                    req.error = err
                    req._q.put(BatchedRequest._DONE)
            while True:
                try:
                    req, _ = self._pending.get_nowait()
                except queue.Empty:
                    break
                req.error = err
                req._q.put(BatchedRequest._DONE)
            if self.paged:
                for req, _ in self._deferred:
                    req.error = err
                    req._q.put(BatchedRequest._DONE)
                self._deferred.clear()

    # ------------- scheduler -------------

    def _admit(self, slot: int, req: BatchedRequest, prepared):
        """Prefill a preprocessed request into ``slot`` (JAX :361-607).
        Returns True, False (the request failed) or _DEFER (paged: too few
        free pages)."""
        eng = self.engine
        try:
            if isinstance(prepared, dict):
                # prefix-aware prep: refresh here, so the page reservation
                # sees the final mode (a burst of same-scene requests all
                # prepares as misses before the first admission stores the
                # prefix); keep the full prep when the upgraded bucket no
                # longer fits the rows
                refreshed = eng._refresh_prep(prepared)
                if refreshed is not prepared and \
                        self.max_cache_len - refreshed["bucket"] > 0:
                    prepared = refreshed
                batch, vision_features = prepared["batch"], \
                    prepared.get("vf")
                bucket = prepared["bucket"]
            else:
                batch, vision_features = prepared
                bucket = int(batch.text_ids.shape[1])
            # clamp the budget to the row: later positions would not fit
            room = self.max_cache_len - bucket
            if room <= 0:
                raise ValueError(
                    f"prompt bucket {bucket} does not fit this batcher's "
                    f"cache rows ({self.max_cache_len})")
            req.max_new_tokens = min(req.max_new_tokens, room)
            if self.paged:
                return self._admit_paged(slot, req, prepared, batch,
                                         vision_features, bucket)
            if isinstance(prepared, dict):
                sub = eng.start_request(prepared,
                                        max_cache_len=self.max_cache_len)
            else:
                sub = start_decode(eng.params, eng.cfg, batch,
                                   self.max_cache_len, vision_features,
                                   eng.cache_dtype)
            self.state = insert_decode_slot(self.state, slot, sub)
            self.slots[slot] = req
            self.emitted[slot] = 0
            return True
        except Exception as e:  # noqa: BLE001 — a request-level failure
            req.error = e
            req._q.put(BatchedRequest._DONE)
            return False

    def _admit_paged(self, slot, req, prepared, batch, vision_features,
                     bucket):
        eng = self.engine
        page = self.page_size
        prompt_pages = pages_needed(bucket, page)
        need = min(pages_needed(bucket + req.max_new_tokens + self.chunk,
                                page), self.max_pages)
        # ---- prefix page sharing (see __init__) ----
        skip, shared = 0, None
        if (self.share_prefix and isinstance(prepared, dict)
                and prepared.get("mode") == "prefix"
                and isinstance(prepared.get("key"), str)):
            key, entry = prepared["key"], prepared["entry"]
            n_full = entry.prefix_len // page
            sig = (entry.prefix_len, entry.ids_prefix)
            cand = self._shared.get(key)
            if cand is not None and cand["sig"] != sig:
                # stale: the engine stored another prefix for this scene
                # (an overwrite fires no eviction hook). Retire it; live
                # slots keep the old pages until they finish.
                self._shared.pop(key, None)
                cand["dead"] = True
                cand["refs"] -= 1
                if cand["refs"] == 0:
                    self._alloc.free(cand["pages"])
                cand = None
            # the cache-hold ref is released only by the eviction hook, so
            # create an entry only while the engine still holds the scene
            with eng._cache_lock:
                engine_holds = key in eng._prefix_cache
            if n_full <= 0 or n_full >= prompt_pages:
                pass                              # nothing to share
            elif cand is not None:
                shared, skip = cand, n_full
            elif engine_holds and self._alloc.available >= need:
                # first shared admission on this scene: write the prefix
                # pages once (n_full + this request's private remainder =
                # exactly `need` pages)
                spages = self._alloc.alloc(n_full)
                try:
                    write_shared_prefix(self.state.cache, entry.cache,
                                        spages, n_full)
                except BaseException:
                    self._alloc.free(spages)
                    raise
                shared = {"pages": spages, "refs": 1, "dead": False,
                          "sig": sig}
                self._shared[key] = shared
                self.prefix_share_stats[1] += 1
                skip = n_full
        private_need = need - skip
        if private_need > self._alloc.num_pages - 1:
            raise ValueError(
                f"request footprint ({private_need} pages) exceeds the page "
                f"pool ({self._alloc.num_pages - 1} usable)")
        if private_need > self._alloc.available:
            return self._DEFER                    # wait for pages to free
        pages = self._alloc.alloc(private_need)
        try:
            row = torch.tensor(
                (shared["pages"][:skip] if shared else []) + pages
                + [0] * (self.max_pages - need), dtype=torch.int32,
                device=eng.device)
            if isinstance(prepared, dict):
                sub = eng.start_request(prepared,
                                        max_cache_len=prompt_pages * page)
            else:
                sub = start_decode(eng.params, eng.cfg, batch,
                                   prompt_pages * page, vision_features,
                                   eng.cache_dtype)
            self.state = insert_paged_slot(self.state, slot, sub, row,
                                           n_pages=prompt_pages,
                                           skip_pages=skip)
        except BaseException:
            self._alloc.free(pages)
            raise
        self._slot_pages[slot] = pages
        if shared is not None:
            shared["refs"] += 1
            self._slot_shared[slot] = shared
            self.prefix_share_stats[0] += 1
        self.slots[slot] = req
        self.emitted[slot] = 0
        return True

    def _finish(self, slot: int):
        """Release a slot, its pages and its shared-prefix reference
        (JAX :715)."""
        if self.paged:
            self.state = release_paged_slot(self.state, slot)
            if self._slot_pages[slot]:
                self._alloc.free(self._slot_pages[slot])
                self._slot_pages[slot] = None
            sh = self._slot_shared[slot]
            if sh is not None:
                self._slot_shared[slot] = None
                sh["refs"] -= 1
                if sh["dead"] and sh["refs"] == 0:
                    self._alloc.free(sh["pages"])
        else:
            self.state = release_decode_slot(self.state, slot)
        req = self.slots[slot]
        self.slots[slot] = None
        if req is not None:
            req._q.put(BatchedRequest._DONE)

    def _drain_evictions(self):
        """Drop the shared prefix pages of scenes the engine evicted."""
        while True:
            try:
                key = self._evicted_keys.get_nowait()
            except queue.Empty:
                return
            sh = self._shared.pop(key, None)
            if sh is None:
                continue
            sh["dead"] = True
            sh["refs"] -= 1                       # the cache-hold ref
            if sh["refs"] == 0:
                self._alloc.free(sh["pages"])

    def _admit_free_slots(self):
        """Fill free slots, deferred admissions first (FIFO); a cancelled
        queued request drops without taking the slot."""
        s = 0
        while s < self.num_slots:
            if self.slots[s] is not None:
                s += 1
                continue
            if self.paged and self._deferred:
                req, prepared = self._deferred[0]
                if req.cancelled.is_set():
                    self._deferred.pop(0)
                    req._q.put(BatchedRequest._DONE)
                    continue                      # same slot, next request
                if self._admit(s, req, prepared) is self._DEFER:
                    return                # still too few pages: keep FIFO
                self._deferred.pop(0)
                s += 1
                continue
            try:
                req, prepared = self._pending.get_nowait()
            except queue.Empty:
                return
            if req.cancelled.is_set():
                req._q.put(BatchedRequest._DONE)
                continue                          # same slot, next request
            if self._admit(s, req, prepared) is self._DEFER:
                self._deferred.append((req, prepared))
                return
            s += 1

    def _loop(self):
        # the state's tensors are updated in place on this thread
        with torch.inference_mode():
            self._loop_impl()

    def _loop_impl(self):
        """The scheduler (JAX :758-980): drain evictions, release cancelled
        slots, admit, then one decode chunk for every slot and the
        emission of its tokens."""
        eng = self.engine
        eos = eng.ecfg.eos_token_id
        while not self._stop.is_set():
            with self._lock:
                if self._stop.is_set():
                    break
                if self.paged and self.share_prefix:
                    self._drain_evictions()
                for s in range(self.num_slots):
                    req = self.slots[s]
                    if req is not None and req.cancelled.is_set():
                        self._finish(s)
                self._admit_free_slots()
            if all(r is None for r in self.slots):
                self._wake.wait(timeout=0.1)
                self._wake.clear()
                continue
            # ---- one decode chunk for every slot ----
            try:
                chunk_fn = paged_decode_chunk if self.paged else decode_chunk
                self.state, toks = chunk_fn(eng.params, eng.cfg, self.state,
                                            chunk=self.chunk,
                                            eos_token_id=eos,
                                            graphs=self._graphs)
                rows = toks.tolist()              # the chunk's one host sync
            except Exception as e:  # noqa: BLE001 — keep the loop alive
                # fail every in-flight request, reset the state, go on
                print(f"[batcher] decode failed: {e!r}; failing "
                      f"{sum(r is not None for r in self.slots)} requests")
                with self._lock:
                    for s in range(self.num_slots):
                        req = self.slots[s]
                        if req is not None:
                            self.slots[s] = None
                            req.error = e
                            req._q.put(BatchedRequest._DONE)
                    self._reset_state()
                continue
            with self._lock:
                for s in range(self.num_slots):
                    req = self.slots[s]
                    if req is None:
                        continue
                    finished = False
                    new = []
                    for t in rows[s]:
                        if t == eos or self.emitted[s] >= req.max_new_tokens:
                            finished = True
                            break
                        new.append(int(t))
                        self.emitted[s] += 1
                    if new:
                        req.tokens.extend(new)
                        req._q.put(len(new))
                    if finished or self.emitted[s] >= req.max_new_tokens:
                        self._finish(s)
