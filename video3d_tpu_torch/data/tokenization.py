"""Tokenization: the full reference preprocess family with the IMAGE_TOKEN
splice contract.

Reproduces the reference tokenization paths bit-for-bit:
  * training (Qwen, the 3D recipe): ``preprocess_qwen`` (train_3d.py:601-674)
    — per-message ChatML encoding, user/system turns masked,
    ``[198 ('\\n'), im_start, im_end]`` unmasked, ``<image>`` mapped to
    IMAGE_TOKEN_INDEX;
  * eval: manual ChatML id assembly with an empty assistant turn
    (model_scanqa.py:29-80);
  * the other-family trainers dispatched by ``preprocess`` (train_3d.py:
    945-966): plain (:922-944), llama_2 (:447-521), v1 (:763-841),
    mpt (:844-920), gemma (:524-598), llama3 (:676-760), and the "### "
    speaker-signal fallback (:388-416,968-994).

Works with any HF-style tokenizer exposing ``__call__`` and the template's
special tokens; tests use fake deterministic tokenizers with the same
interface plus goldens vs the reference functions AST-extracted from
train_3d.py.

The port's own copy of ``video3d_tpu/data/tokenization.py`` (the port imports
nothing of the JAX package).
"""

from __future__ import annotations

import copy as _copy
from typing import Dict, List, Optional, Sequence

import numpy as np

from video3d_tpu_torch.constants import (DEFAULT_IMAGE_TOKEN, IGNORE_INDEX,
                                   IMAGE_TOKEN_INDEX)
from video3d_tpu_torch.data import conversation as conversation_lib
from video3d_tpu_torch.data.conversation import Conversation, SeparatorStyle

NEWLINE_TOKEN_ID = 198  # '\n' in the Qwen2 BPE vocab (train_3d.py:615)

try:  # train_3d.py:56
    import tokenizers as _tokenizers
    from packaging import version as _version

    IS_TOKENIZER_GREATER_THAN_0_14 = (_version.parse(_tokenizers.__version__)
                                      >= _version.parse("0.14"))
except Exception:  # pragma: no cover - tokenizers is a baked-in dep
    IS_TOKENIZER_GREATER_THAN_0_14 = True


def tokenizer_image_token(prompt: str, tokenizer,
                          image_token_index: int = IMAGE_TOKEN_INDEX) -> List[int]:
    """Split on '<image>' and insert the sentinel id (mm_utils.py:341-360).

    Matches the reference's interleaving: chunks are tokenized separately;
    a leading BOS (if the first chunk has one) is kept once.
    """
    chunks = [tokenizer(c).input_ids for c in prompt.split(DEFAULT_IMAGE_TOKEN)]

    def insert_separator(X, sep):
        return [ele for sublist in zip(X, [sep] * len(X)) for ele in sublist][:-1]

    input_ids: List[int] = []
    offset = 0
    if chunks and len(chunks[0]) > 0 and getattr(tokenizer, "bos_token_id", None) is not None \
            and chunks[0][0] == tokenizer.bos_token_id:
        offset = 1
        input_ids.append(chunks[0][0])
    for x in insert_separator(chunks, [image_token_index] * (offset + 1)):
        input_ids.extend(x[offset:])
    return input_ids


def _chatml_ids(tokenizer):
    """(im_start, im_end) ids looked up by token text — robust to tokenizers
    whose additional_special_tokens list other tokens first (the reference
    unpacks additional_special_tokens_ids positionally, train_3d.py:614)."""
    return (tokenizer.convert_tokens_to_ids("<|im_start|>"),
            tokenizer.convert_tokens_to_ids("<|im_end|>"))


def _chatml_turn_ids(tokenizer, role: str, content: str) -> List[int]:
    """ids of '<|im_start|>role\\ncontent<|im_end|>\\n' — what the reference's
    overridden chat template produces per message (train_3d.py:619)."""
    im_start, im_end = _chatml_ids(tokenizer)
    return ([im_start] + tokenizer(f"{role}\n{content}").input_ids
            + [im_end] + tokenizer("\n").input_ids)


def preprocess_qwen(sources: Sequence[Sequence[Dict]], tokenizer,
                    has_image: bool = False,
                    system_message: str = "You are a helpful assistant.",
                    image_token_id: Optional[int] = None) -> Dict[str, np.ndarray]:
    """Training-side ChatML tokenization + label masking (train_3d.py:601-674).

    Args:
      sources: list of conversations; each message has from/value (or
        role/content) keys with roles human/gpt (or user/assistant).
      image_token_id: id that '<image>' tokenizes to (the reference adds it
        as a special token; pass the id your tokenizer assigns).
    Returns:
      dict(input_ids (B, L) int64, labels (B, L) int64) — unpadded per-sample
      lists stacked only when lengths match; otherwise lists.
    """
    roles = {"human": "user", "gpt": "assistant"}
    im_start, im_end = _chatml_ids(tokenizer)
    unmask = {NEWLINE_TOKEN_ID, im_start, im_end}
    if image_token_id is None:
        image_token_id = tokenizer.convert_tokens_to_ids(DEFAULT_IMAGE_TOKEN)

    input_ids, targets = [], []
    for source in sources:
        first_from = source[0].get("from", source[0].get("role"))
        if roles.get(first_from, first_from) != "user":
            source = source[1:]

        ids: List[int] = []
        labs: List[int] = []

        sys_ids = _chatml_turn_ids(tokenizer, "system", system_message)
        ids += sys_ids
        labs += [IGNORE_INDEX] * len(sys_ids)

        for conv in source:
            role = conv.get("role", conv.get("from"))
            content = conv.get("content", conv.get("value"))
            role = roles.get(role, role)
            enc = _chatml_turn_ids(tokenizer, role, content)
            ids += enc
            labs += [IGNORE_INDEX] * len(enc) if role in ("user", "system") else list(enc)

        assert len(ids) == len(labs)
        for i, tok in enumerate(ids):
            if tok in unmask:
                labs[i] = tok
            if tok == image_token_id:
                ids[i] = IMAGE_TOKEN_INDEX
        input_ids.append(np.asarray(ids, np.int64))
        targets.append(np.asarray(labs, np.int64))

    return {"input_ids": input_ids, "labels": targets}


def preprocess_qwen_eval(source: Sequence[Dict], tokenizer,
                         system_message: str = "You are a helpful assistant.") -> List[int]:
    """Eval-side prompt ids: system + turns + empty assistant generation
    header (model_scanqa.py:29-80). '<image>' inside content becomes the
    IMAGE_TOKEN_INDEX sentinel."""
    roles = {"human": "user", "gpt": "assistant"}
    im_start, im_end = _chatml_ids(tokenizer)
    nl = tokenizer("\n").input_ids

    ids: List[int] = []
    ids += _chatml_turn_ids(tokenizer, "system", system_message)
    for conv in source:
        role = roles.get(conv.get("from", conv.get("role")),
                         conv.get("from", conv.get("role")))
        content = conv.get("value", conv.get("content"))
        if content:
            if DEFAULT_IMAGE_TOKEN in content:
                pieces = content.split(DEFAULT_IMAGE_TOKEN)
                body: List[int] = tokenizer(f"{role}\n").input_ids if pieces[0] == "" else \
                    tokenizer(f"{role}\n{pieces[0]}").input_ids
                turn = [im_start] + body
                for piece in pieces[1:]:
                    turn += [IMAGE_TOKEN_INDEX] + tokenizer(piece).input_ids
                turn += [im_end] + nl
            else:
                turn = _chatml_turn_ids(tokenizer, role, content)
            ids += turn
        else:
            # generation header: '<|im_start|>assistant\n'
            ids += [im_start] + tokenizer(f"{role}\n").input_ids
    return ids


# ---------------------------------------------------------------------------
# Non-Qwen preprocessors (train_3d.py:388-994) — list-of-int equivalents of
# the reference's torch-tensor functions; each returns
# dict(input_ids=[np.int64 array per sample], labels=[...]).
# ---------------------------------------------------------------------------

def _encode_truncated(text: str, tokenizer) -> List[int]:
    """tokenizer(text, truncation=True, max_length=model_max_length)
    (_tokenize_fn, train_3d.py:366-377)."""
    ids = tokenizer(text).input_ids
    mml = getattr(tokenizer, "model_max_length", None)
    return list(ids[:mml] if mml else ids)


def _apply_template(sources: Sequence[Sequence[Dict]],
                    conv: Conversation) -> List[str]:
    """Shared prompt assembly of preprocess_{llama_2,v1,mpt,gemma}
    (e.g. train_3d.py:448-463): drop a leading non-human turn, alternate
    roles, render with the template."""
    roles = {"human": conv.roles[0], "gpt": conv.roles[1]}
    conversations = []
    for i, source in enumerate(sources):
        if roles[source[0]["from"]] != conv.roles[0]:
            source = source[1:]
        c = conv.copy()
        c.messages = []
        for j, sentence in enumerate(source):
            role = roles[sentence["from"]]
            assert role == c.roles[j % 2], f"{i}"
            c.append_message(role, sentence["value"])
        conversations.append(c.get_prompt())
    return conversations


def _conv_ids(conversations: Sequence[str], tokenizer,
              has_image: bool) -> List[List[int]]:
    if has_image:
        return [tokenizer_image_token(p, tokenizer) for p in conversations]
    return [_encode_truncated(p, tokenizer) for p in conversations]


def _tok_len(text: str, tokenizer, has_image: bool) -> int:
    if has_image:
        return len(tokenizer_image_token(text, tokenizer))
    return len(tokenizer(text).input_ids)


def _finish(target: np.ndarray, cur_len: int, total_len: int,
            tokenizer) -> None:
    """Common tail of the masking loops: mask everything past the last
    counted round and null the sample on a tokenization mismatch
    (train_3d.py:509-517 et al.)."""
    target[cur_len:] = IGNORE_INDEX
    if cur_len < getattr(tokenizer, "model_max_length", float("inf")):
        if cur_len != total_len:
            target[:] = IGNORE_INDEX
            print(f"WARNING: tokenization mismatch: {cur_len} vs. {total_len}."
                  f" (ignored)")


def preprocess_llama_2(sources, tokenizer, has_image: bool = False,
                       conv: Optional[Conversation] = None) -> Dict:
    """train_3d.py:447-521 ([INST] ... [/INST] rounds split on </s>)."""
    conv = (conv or conversation_lib.conv_llava_llama_2).copy()
    assert conv.sep_style == SeparatorStyle.LLAMA_2
    conversations = _apply_template(sources, conv)
    input_ids = _conv_ids(conversations, tokenizer, has_image)
    targets = [np.asarray(ids, np.int64) for ids in input_ids]

    sep = "[/INST] "
    for conversation, target in zip(conversations, targets):
        total_len = int(np.sum(target != getattr(tokenizer, "pad_token_id",
                                                 None)))
        rounds = conversation.split(conv.sep2)
        cur_len = 1
        target[:cur_len] = IGNORE_INDEX
        for rou in rounds:
            if rou == "":
                break
            parts = rou.split(sep)
            if len(parts) != 2:
                break
            parts[0] += sep
            round_len = _tok_len(rou, tokenizer, has_image)
            instruction_len = _tok_len(parts[0], tokenizer, has_image) - 2
            target[cur_len:cur_len + instruction_len] = IGNORE_INDEX
            cur_len += round_len
        _finish(target, cur_len, total_len, tokenizer)
    return {"input_ids": [np.asarray(i, np.int64) for i in input_ids],
            "labels": targets}


def preprocess_v1(sources, tokenizer, has_image: bool = False,
                  conv: Optional[Conversation] = None) -> Dict:
    """train_3d.py:763-841 (vicuna 'USER: ... ASSISTANT: ...' rounds)."""
    conv = (conv or conversation_lib.conv_vicuna_v1).copy()
    assert conv.sep_style == SeparatorStyle.TWO
    conversations = _apply_template(sources, conv)
    input_ids = _conv_ids(conversations, tokenizer, has_image)
    targets = [np.asarray(ids, np.int64) for ids in input_ids]

    sep = conv.sep + conv.roles[1] + ": "
    for conversation, target in zip(conversations, targets):
        total_len = int(np.sum(target != getattr(tokenizer, "pad_token_id",
                                                 None)))
        rounds = conversation.split(conv.sep2)
        cur_len = 1
        target[:cur_len] = IGNORE_INDEX
        for i, rou in enumerate(rounds):
            if rou == "":
                break
            parts = rou.split(sep)
            if len(parts) != 2:
                break
            parts[0] += sep
            round_len = _tok_len(rou, tokenizer, has_image)
            instruction_len = _tok_len(parts[0], tokenizer, has_image) - 2
            # modern (non-legacy) SP tokenizers drop the space-merge token
            # (train_3d.py:820-823)
            if i != 0 and not getattr(tokenizer, "legacy", True) \
                    and IS_TOKENIZER_GREATER_THAN_0_14:
                round_len -= 1
                instruction_len -= 1
            target[cur_len:cur_len + instruction_len] = IGNORE_INDEX
            cur_len += round_len
        _finish(target, cur_len, total_len, tokenizer)
    return {"input_ids": [np.asarray(i, np.int64) for i in input_ids],
            "labels": targets}


def preprocess_mpt(sources, tokenizer, has_image: bool = False,
                   conv: Optional[Conversation] = None) -> Dict:
    """train_3d.py:844-920 (ChatML-style without trailing newline; rounds
    regrouped [system+user+gpt], then [user+gpt] pairs)."""
    conv = (conv or conversation_lib.conv_mpt).copy()
    assert conv.sep_style == SeparatorStyle.MPT
    conversations = _apply_template(sources, conv)
    input_ids = _conv_ids(conversations, tokenizer, has_image)
    targets = [np.asarray(ids, np.int64) for ids in input_ids]

    sep = conv.sep + conv.roles[1]
    for conversation, target in zip(conversations, targets):
        total_len = int(np.sum(target != getattr(tokenizer, "pad_token_id",
                                                 None)))
        rounds = conversation.split(conv.sep)
        re_rounds = [conv.sep.join(rounds[:3])]
        for conv_idx in range(3, len(rounds), 2):
            re_rounds.append(conv.sep.join(rounds[conv_idx:conv_idx + 2]))
        cur_len = 1
        target[:cur_len] = IGNORE_INDEX
        for i, rou in enumerate(re_rounds):
            if rou == "":
                break
            parts = rou.split(sep)
            if len(parts) != 2:
                break
            parts[0] += sep
            round_len = _tok_len(rou, tokenizer, has_image)
            instruction_len = _tok_len(parts[0], tokenizer, has_image) - 1
            if i != 0 and getattr(tokenizer, "legacy", False) \
                    and IS_TOKENIZER_GREATER_THAN_0_14:
                round_len += 1
                instruction_len += 1
            target[cur_len:cur_len + instruction_len] = IGNORE_INDEX
            cur_len += round_len
        _finish(target, cur_len, total_len, tokenizer)
    return {"input_ids": [np.asarray(i, np.int64) for i in input_ids],
            "labels": targets}


def preprocess_gemma(sources, tokenizer, has_image: bool = False,
                     conv: Optional[Conversation] = None) -> Dict:
    """train_3d.py:524-598 (<start_of_turn> rounds; <bos> and the 2-token
    <end_of_turn>\\n separator accounted explicitly)."""
    conv = (conv or conversation_lib.conv_gemma_instruct).copy()
    assert conv.sep_style == SeparatorStyle.GEMMA
    conversations = _apply_template(sources, conv)
    input_ids = _conv_ids(conversations, tokenizer, has_image)
    targets = [np.asarray(ids, np.int64) for ids in input_ids]

    sep = conv.sep + conv.roles[1]
    for conversation, target in zip(conversations, targets):
        total_len = int(np.sum(target != getattr(tokenizer, "pad_token_id",
                                                 None)))
        rounds = conversation.split(conv.sep)
        re_rounds = [conv.sep.join(rounds[i:i + 2])
                     for i in range(0, len(rounds), 2)]
        cur_len = 1                      # ignore <bos>
        target[:cur_len] = IGNORE_INDEX
        for rou in re_rounds:
            if rou == "":
                break
            parts = rou.split(sep)
            if len(parts) != 2:
                break
            parts[0] += sep
            round_len = _tok_len(rou, tokenizer, has_image) - 1    # no <bos>
            instruction_len = _tok_len(parts[0], tokenizer, has_image) - 1
            round_len += 2               # <end_of_turn>\n takes 2 tokens
            target[cur_len:cur_len + instruction_len] = IGNORE_INDEX
            cur_len += round_len
        _finish(target, cur_len, total_len, tokenizer)
    return {"input_ids": [np.asarray(i, np.int64) for i in input_ids],
            "labels": targets}


def preprocess_llama3(sources, tokenizer, has_image: bool = False,
                      system_message: str =
                      "You are a helpful language and vision assistant. "
                      "You are able to understand the visual content that "
                      "the user provides, and assist the user with a variety "
                      "of tasks using natural language.") -> Dict:
    """train_3d.py:676-760: per-turn apply_chat_template (leading <bos>
    stripped), header/eot tokens unmasked, '<image>' mapped to the sentinel."""
    roles = {"human": "user", "gpt": "assistant"}
    tokenizer = _copy.deepcopy(tokenizer)
    if has_image and hasattr(tokenizer, "add_tokens"):
        tokenizer.add_tokens(["<image>"], special_tokens=True)
    image_token_index = tokenizer.convert_tokens_to_ids("<image>")
    bos_token_id = tokenizer.convert_tokens_to_ids("<|begin_of_text|>")
    unmask_tokens = ["<|begin_of_text|>", "<|start_header_id|>",
                     "<|end_header_id|>", "<|eot_id|>", "\n\n"]
    unmask_tokens_idx = {tokenizer.convert_tokens_to_ids(t)
                         for t in unmask_tokens}

    def safe_apply(conv_msgs):
        ids = tokenizer.apply_chat_template(conv_msgs)
        return ids

    input_ids, targets = [], []
    for source in sources:
        first = source[0].get("from", source[0].get("role"))
        if roles.get(first, first) != "user":
            source = source[1:]

        input_id: List[int] = []
        target: List[int] = []
        sys_ids = safe_apply([{"role": "system", "content": system_message}])
        input_id += sys_ids
        target += [IGNORE_INDEX] * len(sys_ids)
        for conv in source:
            role = conv.get("role", conv.get("from"))
            content = conv.get("content", conv.get("value"))
            role = roles.get(role, role)
            encode_id = safe_apply([{"role": role, "content": content}])
            if encode_id and encode_id[0] == bos_token_id:
                encode_id = encode_id[1:]   # reference drops the per-turn bos
            input_id += encode_id
            if role in ("user", "system"):
                target += [IGNORE_INDEX] * len(encode_id)
            else:
                target += list(encode_id)
        assert len(input_id) == len(target)
        for idx, tok in enumerate(input_id):
            if tok in unmask_tokens_idx:
                target[idx] = tok
            if tok == image_token_index:
                input_id[idx] = IMAGE_TOKEN_INDEX
        input_ids.append(np.asarray(input_id, np.int64))
        targets.append(np.asarray(target, np.int64))
    return {"input_ids": input_ids, "labels": targets}


def preprocess_plain(sources, tokenizer) -> Dict:
    """train_3d.py:922-944: pretraining pairs '<image>' + caption + sep;
    only the caption supervised."""
    conv = conversation_lib.conv_llava_plain
    input_ids, targets = [], []
    for source in sources:
        assert len(source) == 2
        assert DEFAULT_IMAGE_TOKEN in source[0]["value"]
        first = DEFAULT_IMAGE_TOKEN
        conversation = first + source[1]["value"] + conv.sep
        ids = np.asarray(tokenizer_image_token(conversation, tokenizer),
                         np.int64)
        target = ids.copy()
        target[:len(tokenizer_image_token(first, tokenizer))] = IGNORE_INDEX
        input_ids.append(ids)
        targets.append(target)
    return {"input_ids": input_ids, "labels": targets}


def preprocess_single(sources, tokenizer, has_image: bool = False,
                      conv: Optional[Conversation] = None) -> Dict:
    """The '### speaker:' fallback branch of preprocess (train_3d.py:968-994
    with _add_speaker_and_signal :399-416 and _mask_targets :388-396)."""
    conv = conv or conversation_lib.default_conversation
    BEGIN_SIGNAL, END_SIGNAL = "### ", "\n"
    input_ids, targets = [], []
    for source in sources:
        header = f"{conv.system}\n\n"
        pieces = []
        for sentence in source:
            from_str = sentence["from"]
            if from_str.lower() == "human":
                from_str = conv.roles[0]
            elif from_str.lower() == "gpt":
                from_str = conv.roles[1]
            else:
                from_str = "unknown"
            pieces.append(BEGIN_SIGNAL + from_str + ": "
                          + sentence["value"] + END_SIGNAL)
        conversation = header + "".join(pieces) + BEGIN_SIGNAL

        if has_image:
            ids = np.asarray(tokenizer_image_token(conversation, tokenizer),
                             np.int64)
            tokenized_lens = [_tok_len(header, tokenizer, True)] + \
                [_tok_len(p, tokenizer, True) for p in pieces]
        else:
            ids = np.asarray(_encode_truncated(conversation, tokenizer),
                             np.int64)
            tokenized_lens = [len(_encode_truncated(header, tokenizer))] + \
                [len(_encode_truncated(p, tokenizer)) for p in pieces]
        target = ids.copy()
        speakers = [s["from"] for s in source]
        cur_idx = tokenized_lens[0]
        target[:cur_idx] = IGNORE_INDEX
        for tokenized_len, speaker in zip(tokenized_lens[1:], speakers):
            if speaker == "human":
                target[cur_idx + 2:cur_idx + tokenized_len] = IGNORE_INDEX
            cur_idx += tokenized_len
        input_ids.append(ids)
        targets.append(target)
    return {"input_ids": input_ids, "labels": targets}


def preprocess(sources, tokenizer, has_image: bool = False,
               conv: Optional[Conversation] = None) -> Dict:
    """Template-dispatching entry (train_3d.py:945-966)."""
    conv = conv or conversation_lib.default_conversation
    if conv.sep_style == SeparatorStyle.PLAIN:
        return preprocess_plain(sources, tokenizer)
    if conv.sep_style == SeparatorStyle.LLAMA_2:
        return preprocess_llama_2(sources, tokenizer, has_image, conv)
    if conv.version.startswith("v1"):
        return preprocess_v1(sources, tokenizer, has_image, conv)
    if conv.version == "mpt":
        return preprocess_mpt(sources, tokenizer, has_image, conv)
    if conv.version.startswith("qwen"):
        return preprocess_qwen(sources, tokenizer, has_image)
    if conv.version == "gemma":
        return preprocess_gemma(sources, tokenizer, has_image, conv)
    if conv.version == "llama_v3":
        return preprocess_llama3(sources, tokenizer, has_image)
    return preprocess_single(sources, tokenizer, has_image, conv)
