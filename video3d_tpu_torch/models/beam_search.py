"""Beam search over the multimodal prefill, in PyTorch: counterpart of
``video3d_tpu/models/beam_search.py`` (HF's beam_search + BeamSearchScorer
semantics; the reference's eval drivers expose ``--num_beams``,
model_scanqa.py:230):

  * the first step starts every beam from beam 0 (scores [0, -1e9, ...]);
  * each step takes the top ``2K`` of ``log_softmax + beam_score`` over
    (K*V); EOS candidates ranked < K become finished hypotheses, the first
    K non-EOS candidates in score order the next beams;
  * hypotheses keep ``sum_logprobs / generated_len ** length_penalty``
    (only generated tokens count, as HF >= 4.38 with
    ``decoder_prompt_len``);
  * ``early_stopping=True`` ends a batch row once it holds K hypotheses;
    False uses HF's highest-attainable-score test;
  * at exhaustion, the running beams of unfinished rows are finalized as
    hypotheses and the best one is returned.

The JAX ``lax.while_loop`` is here a loop of eager steps with one host
check of the rows' ``done`` per ``DECODE_CHUNK`` steps (a finished row's
state is frozen, so the steps run past its end change nothing that is
returned). Each step reorders the K beams' caches by their source beams:
the rows are gathered into a second cache of the same shape and the two
swap roles, so no step allocates a cache. Beam
decode runs eagerly, never as a captured graph: the swap moves the cache
between two buffers every step, and the decode graphs
(``models/decode_graph.py``) replay over one static state.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from video3d_tpu_torch.config import ModelConfig
from video3d_tpu_torch.models import llava_video3d as lv3d
from video3d_tpu_torch.models import qwen2
from video3d_tpu_torch.models.decode_graph import DECODE_CHUNK
from video3d_tpu_torch.models.generate import prefill_multimodal

NEG_INF = -1e9


class BeamResult(NamedTuple):
    """``GenerateResult``'s fields and the beam search's own: the returned
    hypothesis's score (its summed log-probabilities over
    ``generated_len ** length_penalty``) and the steps run."""

    tokens: torch.Tensor    # (B, max_new_tokens) ids, EOS-padded
    lengths: torch.Tensor   # (B,) tokens before EOS
    scores: torch.Tensor    # (B,) float32
    steps: int


class _BeamState:
    """The beams of B rows (JAX ``_BeamState``), updated step by step."""

    def __init__(self, B: int, K: int, T: int, eos: int, cache, spare,
                 next_logits: torch.Tensor):
        dev = next_logits.device
        self.step = 0
        self.beam_scores = torch.full((B, K), NEG_INF, dtype=torch.float32,
                                      device=dev)
        self.beam_scores[:, 0] = 0.0
        self.tokens = torch.full((B, K, T), eos, dtype=torch.long, device=dev)
        self.cache = cache            # (layers, B*K, S, ...)
        self.spare = spare            # the reorder's destination
        self.next_logits = next_logits            # (B*K, V)
        self.hyp_scores = torch.full((B, K), float("-inf"),
                                     dtype=torch.float32, device=dev)
        self.hyp_tokens = torch.full((B, K, T), eos, dtype=torch.long,
                                     device=dev)
        self.hyp_lens = torch.zeros((B, K), dtype=torch.long, device=dev)
        self.done = torch.zeros(B, dtype=torch.bool, device=dev)


def _expand_cache(cache: qwen2.KVCache, num_beams: int) -> qwen2.KVCache:
    """(layers, B, S, ...) -> (layers, B*K, S, ...), each row repeated K
    times: values and, for int8 / int4 caches, their scales (int4's packed
    bytes are copied as they are)."""
    return qwen2.KVCache(*(None if t is None
                           else t.repeat_interleave(num_beams, dim=1)
                           for t in cache))


def _reorder_cache(cache: qwen2.KVCache, flat_idx: torch.Tensor,
                   out: qwen2.KVCache) -> qwen2.KVCache:
    """Rows ``flat_idx`` of every tensor of ``cache`` (values and scales)
    gathered into ``out``, one ``index_select`` each; returns ``out``."""
    for src, dst in zip(cache, out):
        if src is not None:
            torch.index_select(src, 1, flat_idx, out=dst)
    return out


def reorder_nbytes(cache: qwen2.KVCache) -> int:
    """Bytes one reorder of ``cache`` reads and writes (every tensor,
    values and scales)."""
    return sum(2 * t.numel() * t.element_size() for t in cache
               if t is not None)


def _try_add(st: _BeamState, add: torch.Tensor, cand_tokens: torch.Tensor,
             cand_score: torch.Tensor, pen_len: torch.Tensor,
             gen_len: int, length_penalty: float, K: int) -> None:
    """BeamHypotheses.add: where ``add``, insert (cand, score /
    pen_len ** length_penalty) in place of a row's worst hypothesis when it
    beats it (JAX ``_try_add_hypothesis`` / ``_finalize_add``)."""
    norm = cand_score / pen_len ** length_penalty
    worst = torch.argmin(st.hyp_scores, dim=-1)
    worst_score = torch.gather(st.hyp_scores, -1, worst[:, None])[:, 0]
    do = add & (norm > worst_score)
    onehot = (torch.arange(K, device=worst.device) == worst[:, None]) \
        & do[:, None]
    st.hyp_scores = torch.where(onehot, norm[:, None], st.hyp_scores)
    st.hyp_tokens = torch.where(onehot[:, :, None], cand_tokens[:, None, :],
                                st.hyp_tokens)
    st.hyp_lens = torch.where(onehot, gen_len, st.hyp_lens)


def _beam_step(params, cfg: ModelConfig, st: _BeamState,
               prompt_len: torch.Tensor, eos: int,
               length_penalty: float, early_stopping: bool) -> None:
    """One beam step (the body of JAX's while loop), ``st`` updated."""
    B, K, T = st.tokens.shape
    V = st.next_logits.shape[-1]
    dev = st.next_logits.device
    s = st.step
    logp = torch.log_softmax(st.next_logits.float(), dim=-1)
    scores = logp.view(B, K, V) + st.beam_scores[:, :, None]
    top_scores, top_idx = torch.topk(scores.view(B, K * V), 2 * K, dim=-1)
    cand_beam = torch.div(top_idx, V, rounding_mode="floor")
    cand_tok = top_idx % V
    is_eos = cand_tok == eos

    # finished hypotheses: EOS candidates ranked < K (scorer.process);
    # generated_len = step + 1 with the EOS, step tokens before it
    pen_len = torch.full((), float(s + 1), dtype=torch.float32, device=dev)
    rows = torch.arange(B, device=dev)
    for c in range(K):
        _try_add(st, is_eos[:, c] & ~st.done,
                 st.tokens[rows, cand_beam[:, c]], top_scores[:, c],
                 pen_len, s, length_penalty, K)

    # next running beams: the first K non-EOS candidates in score order
    # (a beam gives at most one EOS candidate, so there are K)
    sel = torch.sort(is_eos.to(torch.uint8), dim=-1, stable=True) \
        .indices[:, :K]
    keep = st.done[:, None]
    new_scores = torch.where(keep, st.beam_scores,
                             torch.gather(top_scores, -1, sel))
    new_tok = torch.where(keep, eos, torch.gather(cand_tok, -1, sel))
    new_beam = torch.where(keep, torch.arange(K, device=dev)[None],
                           torch.gather(cand_beam, -1, sel))

    # reorder the token history and the cache by the source beams
    st.tokens = torch.gather(st.tokens, 1,
                             new_beam[:, :, None].expand(B, K, T))
    st.tokens[:, :, s] = new_tok
    flat_idx = ((rows * K)[:, None] + new_beam).reshape(-1)
    st.cache, st.spare = (_reorder_cache(st.cache, flat_idx, st.spare),
                          st.cache)

    # BeamHypotheses.is_done
    n_hyps = (st.hyp_scores > float("-inf")).sum(-1)
    worst = st.hyp_scores.min(dim=-1).values
    best_attainable = top_scores[:, 0] / pen_len ** length_penalty
    newly = n_hyps >= K
    if not early_stopping:
        newly = newly & (worst >= best_attainable)
    st.done = st.done | newly
    st.beam_scores = new_scores

    # one decode step of the new beams
    pos = (prompt_len[:, None] + s).expand(B, K).reshape(-1)
    hidden = qwen2.qwen2_forward(
        params["llm"], cfg.llm,
        qwen2.embed_tokens(params["llm"], new_tok.reshape(-1)[:, None]),
        pos[:, None, None].expand(B * K, 1, 3), kv_cache=st.cache,
        cache_positions=pos[:, None], kv_len=pos + 1)
    st.next_logits = qwen2.lm_head(params["llm"], hidden)[:, 0]
    st.step = s + 1


@torch.inference_mode()
def generate_beam(params, cfg: ModelConfig, batch: lv3d.Batch,
                  num_beams: int = 4, max_new_tokens: int = 512,
                  eos_token_id: int = 151645,
                  max_cache_len: Optional[int] = None,
                  cache_dtype=torch.bfloat16, length_penalty: float = 1.0,
                  early_stopping: bool = False,
                  vision_features: Optional[torch.Tensor] = None
                  ) -> BeamResult:
    """Beam-search decode, the interface of ``generate_greedy`` plus the
    beam settings; returns the best hypothesis of each row (tokens padded
    with EOS, lengths before EOS, its score). The cache (bf16, int8 or
    ``qwen2.KV_INT4``) holds B * num_beams rows, twice (see the module
    docstring)."""
    B, L = batch.text_ids.shape
    K, T = num_beams, max_new_tokens
    if max_cache_len is None:
        max_cache_len = L + T
    next_logits, cache, start_pos = prefill_multimodal(
        params, cfg, batch, max_cache_len, vision_features, cache_dtype)
    cache = _expand_cache(cache, K)
    spare = qwen2.KVCache(*(None if t is None else torch.empty_like(t)
                            for t in cache))
    st = _BeamState(B, K, T, eos_token_id, cache, spare,
                    next_logits.repeat_interleave(K, dim=0))
    prompt_len = start_pos.long()
    while st.step < T:
        for _ in range(min(DECODE_CHUNK, T - st.step)):
            _beam_step(params, cfg, st, prompt_len, eos_token_id,
                       length_penalty, early_stopping)
        if bool(st.done.all()):
            break

    # finalize (BeamSearchScorer.finalize): the running beams of unfinished
    # rows become hypotheses of the full generated length
    steps = torch.full((), float(st.step), dtype=torch.float32,
                       device=st.done.device)
    for k in range(K):
        _try_add(st, ~st.done, st.tokens[:, k], st.beam_scores[:, k],
                 steps, st.step, length_penalty, K)
    best = torch.argmax(st.hyp_scores, dim=-1)
    rows = torch.arange(B, device=best.device)
    return BeamResult(tokens=st.hyp_tokens[rows, best],
                      lengths=st.hyp_lens[rows, best],
                      scores=st.hyp_scores[rows, best], steps=st.step)
