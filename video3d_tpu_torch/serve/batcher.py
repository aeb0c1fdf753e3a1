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

Every decode chunk draws with the engine's sampling settings
(``EngineConfig.temperature`` / ``top_p`` / ``top_k``; greedy at
temperature 0; as in JAX, ``num_beams`` does not apply to the batcher),
and a request may carry a Scan2Cap ``box_input`` with its
``coord_token_id``, as in JAX.

Speculative mode (``draft_params``, a draft attached to the engine, or the
engine's self-draft): every slot carries a draft cache beside its target
rows or pages and a chunk runs ``chunk`` speculative rounds
(``models/speculative.py``, eagerly), each emitting 1..K+1 tokens per
slot; the admission's prefill emits the first token. Rows and page
reservations hold the verify's K+2 write-ahead. With
``speculative_min_acceptance`` set, a low measured acceptance demotes the
batcher to plain decoding at the next idle boundary (a new state, and a
new holder of graphs).

Chunked prefill (``chunked_prefill`` > 0, Sarathi-style): a cold
full-prefill admission runs as a ``ChunkedPrefill`` job, one bounded unit
(the tower, or one chunk of that many tokens) per scheduler iteration
between decode chunks, so decode stalls for about one unit instead of the
whole prefill; one job at a time, FIFO. Prefix hits stay atomic, and
speculative mode turns chunking off, as in JAX.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import torch

from video3d_tpu_torch.models import speculative as spec
from video3d_tpu_torch.models.decode_graph import DecodeGraphs
from video3d_tpu_torch.models.generate import (ChunkedPrefill, decode_chunk,
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
from video3d_tpu_torch.params import check_card_path


class BatchedRequest:
    """Handle returned by :meth:`ContinuousBatcher.submit`."""

    _DONE = object()

    def __init__(self, record, box_input, coord_token_id,
                 max_new_tokens: int):
        self.record = record
        # Scan2Cap: the object's (3,) center and the <coord> token's id
        self.box_input = box_input
        self.coord_token_id = coord_token_id
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
      draft_params, draft_cfg: speculative mode with this draft (an
        ``LLMConfig``); without one, the engine's attached draft or its
        self-draft (``EngineConfig.speculative_draft_layers``) turns it on.
        A row, or a page reservation, then holds K+2 more positions.
      chunked_prefill: tokens per chunk of a cold admission's chunked
        prefill (0: atomic prefills); off in speculative mode.
    """

    _DEFER = object()

    def __init__(self, engine, num_slots: int = 4, chunk: int = 8,
                 max_cache_len: Optional[int] = None,
                 draft_params=None, draft_cfg=None,
                 paged: bool = False, page_size: int = 128,
                 total_pages: Optional[int] = None,
                 share_prefix_pages: bool = True,
                 chunked_prefill: int = 0):
        # paged decode has no ALiBi (JAX asserts); its B7 forms take head
        # widths 128 and 256 over every pool form (params.CARD_HEAD_DIMS)
        check_card_path(engine.cfg, engine.device,
                        "paged" if paged else "answer")
        self.engine = engine
        self.num_slots = num_slots
        self.chunk = chunk
        ecfg = engine.ecfg
        self.max_cache_len = max_cache_len or (max(ecfg.buckets)
                                               + ecfg.max_new_tokens)
        self.paged = paged
        # speculative mode (JAX :147-168): explicit draft weights, the
        # engine's attached draft, or its early-exit self-draft, whose
        # prefix K/V seeds from the scene-prefix entry (spec_start_prefix)
        self.draft_params, self.draft_cfg = draft_params, draft_cfg
        if self.draft_params is None and engine.draft_params is not None:
            self.draft_params = engine.draft_params
            self.draft_cfg = engine.draft_cfg
        self._self_draft_spec = False
        if self.draft_params is None and ecfg.speculative_draft_layers > 0:
            self.draft_params, self.draft_cfg = engine._self_draft()
            self._self_draft_spec = True
        self.spec = self.draft_params is not None
        self.spec_k = ecfg.speculative_k
        # the verify writes up to K+2 positions past the kept prefix
        slack = self.spec_k + 2 if self.spec else 0
        if paged:
            # each admission reserves its whole footprint (prompt bucket +
            # max_new_tokens + the chunk's overshoot + the verify's
            # write-ahead), so a chunk never runs out of pages mid-flight
            self.page_size = page_size
            self.max_pages = -(-(self.max_cache_len + chunk + slack)
                               // page_size)
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
        else:
            self.max_cache_len += slack
        # chunked prefill (JAX :233-247): cold full-prefill admissions run
        # as one job at a time; prefix hits stay atomic; off when
        # speculating
        self.chunk_prefill = 0 if self.spec else max(0, int(chunked_prefill))
        self._job = None          # {"req", "prep", "stepper", "bucket"}
        self._chunkq: list = []   # (req, prep) awaiting the job pipeline
        # a finished job waiting for a slot or pages: the idle loop sleeps
        self._job_blocked = False
        # the batcher's min-acceptance guard, from kept emissions
        self._spec_offered = 0
        self._spec_accepted = 0
        self._spec_demote = False
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
            if self.spec:
                # the draft's rows stay dense, with the dense verify slack
                self.state = spec.empty_paged_spec_slots(
                    eng.cfg, self.draft_cfg, self.num_slots,
                    self.total_pages, self.page_size, self.max_pages,
                    self.max_cache_len + self.spec_k + 2,
                    cache_dtype=eng.cache_dtype, device=eng.device)
            else:
                self.state = empty_paged_state(
                    eng.cfg, self.num_slots, self.total_pages,
                    self.page_size, self.max_pages,
                    cache_dtype=eng.cache_dtype, device=eng.device)
            self._alloc = PageAllocator(self.total_pages)
            self._slot_pages: list = [None] * self.num_slots
            self._shared: dict = {}
            self._slot_shared: list = [None] * self.num_slots
        elif self.spec:
            self.state = spec.empty_spec_slots(
                eng.cfg, self.draft_cfg, self.num_slots, self.max_cache_len,
                cache_dtype=eng.cache_dtype, device=eng.device)
        else:
            self.state = empty_decode_state(
                eng.cfg, self.num_slots, self.max_cache_len,
                cache_dtype=eng.cache_dtype, device=eng.device)

    # ------------- public API -------------

    def submit(self, record, box_input=None, coord_token_id=None,
               max_new_tokens: Optional[int] = None) -> BatchedRequest:
        """Queue a record; its preprocessing runs on the prep pool (JAX
        :277). ``box_input``: a Scan2Cap object's (3,) center in world
        coordinates, its PE added at the ``coord_token_id`` slot."""
        req = BatchedRequest(
            record, box_input, coord_token_id,
            self.engine.ecfg.max_new_tokens if max_new_tokens is None
            else max(0, int(max_new_tokens)))   # 0 is a valid budget

        def prepare():
            try:
                eng = self.engine
                use_prefix = (self._self_draft_spec
                              and eng._prefix_cache_spec_on(req.record)
                              if self.spec
                              else eng._prefix_cache_on(req.record))
                if use_prefix:
                    # scene-prefix path: a hit skips video IO, geometry and
                    # the tower here and most of the prefill in _admit
                    prepared = eng.prepare_request(
                        req.record, req.box_input, req.coord_token_id)
                else:
                    prepared = eng._prepare_generation(
                        req.record, req.box_input, req.coord_token_id)
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
            self._fail_chunk_pipeline(err)
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

    def _slack(self) -> int:
        """Positions a dense speculative row holds past its budget."""
        return self.spec_k + 2 if self.spec and not self.paged else 0

    def _admit(self, slot: int, req: BatchedRequest, prepared):
        """Prefill a preprocessed request into ``slot`` (JAX :361-607), or
        copy in the finished state of a chunked prefill (mode
        ``chunked_state``). Returns True, False (the request failed) or
        _DEFER (paged: too few free pages)."""
        eng = self.engine
        try:
            if isinstance(prepared, dict) \
                    and prepared.get("mode") == "chunked_state":
                batch = vision_features = None
                bucket = prepared["bucket"]
            elif isinstance(prepared, dict):
                # prefix-aware prep: refresh here, so the page reservation
                # sees the final mode (a burst of same-scene requests all
                # prepares as misses before the first admission stores the
                # prefix); keep the full prep when the upgraded bucket no
                # longer fits the rows
                refreshed = eng._refresh_prep(prepared)
                if refreshed is not prepared and self.max_cache_len \
                        - refreshed["bucket"] - self._slack() > 0:
                    prepared = refreshed
                batch, vision_features = prepared["batch"], \
                    prepared.get("vf")
                bucket = prepared["bucket"]
            else:
                batch, vision_features = prepared
                bucket = int(batch.text_ids.shape[1])
            # clamp the budget to the row: later positions would not fit
            # (a dense speculative row was grown by the verify's slack,
            # which this takes back)
            room = self.max_cache_len - bucket - self._slack()
            if room <= 0:
                raise ValueError(
                    f"prompt bucket {bucket} does not fit this batcher's "
                    f"cache rows ({self.max_cache_len})")
            req.max_new_tokens = min(req.max_new_tokens, room)
            if self.paged:
                return self._admit_paged(slot, req, prepared, batch,
                                         vision_features, bucket)
            if self.spec:
                sub, first = self._spec_start(prepared, batch,
                                              vision_features,
                                              self.max_cache_len)
                self.state = spec.insert_spec_slot(self.state, slot, sub)
                self._take_slot(slot, req, first)
                return True
            sub = self._start(prepared, batch, vision_features,
                              self.max_cache_len)
            self.state = insert_decode_slot(self.state, slot, sub)
            self._take_slot(slot, req)
            return True
        except Exception as e:  # noqa: BLE001 — a request-level failure
            req.error = e
            req._q.put(BatchedRequest._DONE)
            return False

    def _start(self, prepared, batch, vision_features, max_cache_len):
        """The B=1 DecodeState of an admission: a chunked prefill's, the
        engine's (prefix-aware prep) or a full prefill's."""
        eng = self.engine
        if isinstance(prepared, dict) and prepared["mode"] == "chunked_state":
            return prepared["state"]
        if isinstance(prepared, dict):
            return eng.start_request(prepared, max_cache_len=max_cache_len)
        return start_decode(eng.params, eng.cfg, batch, max_cache_len,
                            vision_features, eng.cache_dtype)

    def _spec_start(self, prepared, batch, vision_features, max_cache_len,
                    draft_max_cache_len=None):
        """(one-slot SpecSlots, first token) of a speculative admission."""
        eng = self.engine
        if isinstance(prepared, dict):
            return eng.start_spec_request(
                prepared, self.draft_params, self.draft_cfg,
                max_cache_len=max_cache_len,
                draft_max_cache_len=draft_max_cache_len)
        return spec.spec_start(
            eng.params, self.draft_params, eng.cfg, self.draft_cfg, batch,
            max_cache_len, eng.cache_dtype, vision_features=vision_features,
            draft_max_cache_len=draft_max_cache_len, **eng.ecfg.sampling())

    def _take_slot(self, slot: int, req: BatchedRequest, first=None):
        """Bind ``req`` to ``slot``; a speculative admission's prefill has
        emitted the ``first`` token already."""
        self.slots[slot] = req
        self.emitted[slot] = 0
        if first is None:
            return
        tok0 = int(first[0])
        if tok0 == self.engine.ecfg.eos_token_id or req.max_new_tokens == 0:
            self._finish(slot)
        else:
            req.tokens.append(tok0)
            self.emitted[slot] = 1
            req._q.put(1)

    def _admit_paged(self, slot, req, prepared, batch, vision_features,
                     bucket):
        eng = self.engine
        page = self.page_size
        prompt_pages = pages_needed(bucket, page)
        overshoot = self.chunk + (self.spec_k + 2 if self.spec else 0)
        need = min(pages_needed(bucket + req.max_new_tokens + overshoot,
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
        first = None
        try:
            row = torch.tensor(
                (shared["pages"][:skip] if shared else []) + pages
                + [0] * (self.max_pages - need), dtype=torch.int32,
                device=eng.device)
            if self.spec:
                sub, first = self._spec_start(
                    prepared, batch, vision_features, prompt_pages * page,
                    self.state.d_cache.k.shape[2])
                self.state = spec.insert_paged_spec_slot(
                    self.state, slot, sub, row, n_pages=prompt_pages,
                    skip_pages=skip)
            else:
                sub = self._start(prepared, batch, vision_features,
                                  prompt_pages * page)
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
        self._take_slot(slot, req, first)
        return True

    def _step_admission_job(self):
        """One bounded unit of a cold admission's chunked prefill (JAX
        :609): start the next queued job, run the current one's next unit,
        or copy a finished state into a free slot. Runs on the scheduler
        thread between decode chunks."""
        eng = self.engine
        self._job_blocked = False
        with self._lock:
            if self._job is None and self._chunkq:
                req, prep = self._chunkq.pop(0)
                if req.cancelled.is_set():
                    req._q.put(BatchedRequest._DONE)
                    return
                self._job = {"req": req, "prep": prep, "stepper": None,
                             "bucket": None}
            job = self._job
        if job is None:
            return
        req = job["req"]
        if req.cancelled.is_set():
            with self._lock:
                self._job = None
            req._q.put(BatchedRequest._DONE)
            return
        try:
            if job["stepper"] is None:
                prep = job["prep"]
                if isinstance(prep, dict):
                    # a prefix may have appeared while queued; a prefix
                    # prep comes back from start_request_chunked finished
                    refreshed = eng._refresh_prep(prep)
                    if refreshed is not prep \
                            and self.max_cache_len - refreshed["bucket"] > 0:
                        prep = refreshed
                    job["prep"] = prep
                    job["bucket"] = prep["bucket"]
                else:
                    job["bucket"] = int(prep[0].text_ids.shape[1])
                mcl = (pages_needed(job["bucket"], self.page_size)
                       * self.page_size if self.paged
                       else self.max_cache_len)
                if isinstance(prep, dict):
                    job["stepper"] = eng.start_request_chunked(
                        prep, max_cache_len=mcl, chunk_len=self.chunk_prefill)
                else:
                    batch, vf = prep
                    job["stepper"] = ChunkedPrefill(
                        eng.params, eng.cfg, batch, mcl,
                        chunk_len=self.chunk_prefill,
                        cache_dtype=eng.cache_dtype, vision_features=vf)
            stepper = job["stepper"]
            if isinstance(stepper, ChunkedPrefill):
                if not stepper.step():
                    return                        # more chunks to go
                state = stepper.result()
                if isinstance(job["prep"], dict):
                    # store the scene prefix as the atomic full path does
                    state = eng.finish_chunked(job["prep"], state)
                job["stepper"] = state
            state = job["stepper"]                # a finished DecodeState
        except Exception as e:  # noqa: BLE001 — a request-level failure
            with self._lock:
                self._job = None
            req.error = e
            req._q.put(BatchedRequest._DONE)
            return
        with self._lock:
            slot = next((s for s in range(self.num_slots)
                         if self.slots[s] is None), None)
            if slot is None:
                self._job_blocked = True          # retry when a slot frees
                return
            prepared = {"mode": "chunked_state", "state": state,
                        "bucket": job["bucket"]}
            if self._admit(slot, req, prepared) is self._DEFER:
                self._job_blocked = True          # retry when pages free
                return
            self._job = None

    def _fail_chunk_pipeline(self, err: Exception) -> None:
        """Fail the job in progress and every queued chunked admission
        (JAX :702; a decode failure's reset, shutdown). The caller holds
        ``_lock``."""
        if self._job is not None:
            req = self._job["req"]
            self._job = None
            req.error = err
            req._q.put(BatchedRequest._DONE)
        for req, _ in self._chunkq:
            req.error = err
            req._q.put(BatchedRequest._DONE)
        self._chunkq.clear()

    def _finish(self, slot: int):
        """Release a slot, its pages and its shared-prefix reference
        (JAX :715)."""
        if self.spec:
            self.state = spec.release_spec_slot(self.state, slot)
        elif self.paged:
            self.state = release_paged_slot(self.state, slot)
        else:
            self.state = release_decode_slot(self.state, slot)
        if self.paged:
            if self._slot_pages[slot]:
                self._alloc.free(self._slot_pages[slot])
                self._slot_pages[slot] = None
            sh = self._slot_shared[slot]
            if sh is not None:
                self._slot_shared[slot] = None
                sh["refs"] -= 1
                if sh["dead"] and sh["refs"] == 0:
                    self._alloc.free(sh["pages"])
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
        queued request drops without taking the slot. With chunked prefill
        on, a cold full-prefill admission joins the job queue instead."""
        eng = self.engine
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
            if self.chunk_prefill:
                if isinstance(prepared, dict):
                    # refresh once here (an upgraded prep refreshes as a
                    # no-op later); keep the full prep when the upgraded
                    # bucket outgrows the rows
                    refreshed = eng._refresh_prep(prepared)
                    if refreshed is not prepared and \
                            self.max_cache_len - refreshed["bucket"] > 0:
                        prepared = refreshed
                if not isinstance(prepared, dict) \
                        or prepared["mode"] == "full":
                    self._chunkq.append((req, prepared))
                    continue                      # same slot, next request
            if self._admit(s, req, prepared) is self._DEFER:
                self._deferred.append((req, prepared))
                return
            s += 1

    def _loop(self):
        # the state's tensors are updated in place on this thread
        with torch.inference_mode():
            self._loop_impl()

    def _decode_rows(self):
        """One decode chunk for every slot; returns each slot's emitted ids
        in order (the chunk's one host sync)."""
        eng = self.engine
        eos = eng.ecfg.eos_token_id
        if not self.spec:
            chunk_fn = paged_decode_chunk if self.paged else decode_chunk
            self.state, toks = chunk_fn(eng.params, eng.cfg, self.state,
                                        chunk=self.chunk, eos_token_id=eos,
                                        graphs=self._graphs,
                                        **eng.ecfg.sampling())
            return toks.tolist()
        K = self.spec_k
        chunk_fn = (spec.paged_spec_decode_chunk if self.paged
                    else spec.spec_decode_chunk)
        self.state, emit, keep = chunk_fn(
            eng.params, self.draft_params, eng.cfg, self.draft_cfg,
            self.state, iters=self.chunk, num_draft_tokens=K,
            eos_token_id=eos, **eng.ecfg.sampling())
        # kept emissions in order, -1 elsewhere (token ids are >= 0)
        kept = torch.where(keep, emit, -1).tolist()
        min_acc = eng.ecfg.speculative_min_acceptance
        if min_acc > 0 and not self._spec_demote:
            # a round that keeps anything keeps one correction or bonus
            # token and its accepted drafts, out of K offered
            counts = [sum(t >= 0 for t in rnd) for slot in kept
                      for rnd in slot]
            active = sum(c > 0 for c in counts)
            self._spec_offered += active * K
            self._spec_accepted += max(sum(counts) - active, 0)
            if self._spec_offered >= 20 * K and \
                    self._spec_accepted / self._spec_offered < min_acc:
                self._spec_demote = True
        return [[t for rnd in slot for t in rnd if t >= 0] for slot in kept]

    def _loop_impl(self):
        """The scheduler (JAX :758-980): drain evictions, demote from
        speculation at an idle boundary, release cancelled slots, admit,
        one unit of a chunked-prefill job, then one decode chunk for every
        slot and the emission of its tokens."""
        eng = self.engine
        eos = eng.ecfg.eos_token_id
        while not self._stop.is_set():
            with self._lock:
                if self._stop.is_set():
                    break
                if self.paged and self.share_prefix:
                    self._drain_evictions()
                if self._spec_demote and self.spec \
                        and all(r is None for r in self.slots):
                    print("[batcher] speculative acceptance below "
                          f"{eng.ecfg.speculative_min_acceptance}; demoting "
                          "to plain continuous batching")
                    self.spec = False
                    # a new state and a new holder of graphs: no graph may
                    # replay over a state it was not captured on
                    self._reset_state()
                for s in range(self.num_slots):
                    req = self.slots[s]
                    if req is not None and req.cancelled.is_set():
                        self._finish(s)
                self._admit_free_slots()
            if self.chunk_prefill:
                self._step_admission_job()
            if all(r is None for r in self.slots):
                if (self._job is None and not self._chunkq) \
                        or self._job_blocked:
                    self._wake.wait(timeout=0.1)
                    self._wake.clear()
                continue
            # ---- one decode chunk for every slot ----
            try:
                rows = self._decode_rows()
            except Exception as e:  # noqa: BLE001 — keep the loop alive
                # fail every in-flight request, reset the state, go on
                print(f"[batcher] decode failed: {e!r}; failing "
                      f"{sum(r is not None for r in self.slots)} requests")
                with self._lock:
                    self._fail_chunk_pipeline(e)
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
