"""Prompt emphasis: "(word:1.2)", "(word)", "[word]" (port of
tinyfusers_tpu/tokenizer/prompt_weights.py).

- "(text)"      weight x1.1 (nesting multiplies)
- "[text]"      weight /1.1
- "(text:1.3)"  explicit weight
- "\\(" "\\)"    literal parens

CLIP runs on the plain token stream; pipeline/sd.py::apply_prompt_weights
then scales each token's hidden state about the sequence mean.
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Tuple

from . import bpe

_ESCAPED = {"\\(": "(", "\\)": ")", "\\[": "[", "\\]": "]"}


def parse(text: str) -> List[Tuple[str, float]]:
    """-> [(fragment, weight)] in order; a weight is the product of the
    emphasis groups around its fragment."""
    out: List[Tuple[str, float]] = []
    stack: List[float] = []  # the multiplier of each open group
    i = 0
    buf = ""

    def weight() -> float:
        w = 1.0
        for m in stack:
            w *= m
        return w

    def flush():
        nonlocal buf
        if buf:
            out.append((buf, weight()))
            buf = ""

    while i < len(text):
        two = text[i:i + 2]
        ch = text[i]
        if two in _ESCAPED:
            buf += _ESCAPED[two]
            i += 2
            continue
        if ch == "(":
            flush()
            stack.append(1.1)
            i += 1
            continue
        if ch == "[":
            flush()
            stack.append(1.0 / 1.1)
            i += 1
            continue
        if ch == ":" and stack:
            # an explicit weight closing a "(" group
            m = re.match(r":([0-9]*\.?[0-9]+)\)", text[i:])
            if m:
                stack[-1] = float(m.group(1))
                flush()
                stack.pop()
                i += m.end()
                continue
            buf += ch
            i += 1
            continue
        if ch in ")]":
            flush()
            if stack:
                stack.pop()
            i += 1
            continue
        buf += ch
        i += 1
    flush()
    return [(t, w) for t, w in out if t.strip() or t == " "]


def encode_weighted(
    tokenizer: "bpe.ClipTokenizer", text: str, length: int = bpe.CONTEXT_LENGTH,
    pad_token: Optional[int] = None,
    placeholders: Optional[Dict[str, Sequence[int]]] = None,
) -> Tuple[List[int], List[float]]:
    """-> (ids padded to ``length``, one weight a token); SOT, EOT and the
    padding weigh 1.0. ``pad_token`` as in ClipTokenizer.encode (0 for
    OpenCLIP). ``placeholders`` maps textual-inversion words to their
    learned ids (case-insensitive); a placeholder takes the weight of the
    fragment it stands in."""
    ids: List[int] = []
    weights: List[float] = []

    def frag_encode(frag: str) -> List[int]:
        if not placeholders:
            return tokenizer.encode_text(frag)
        lowered = {k.lower(): v for k, v in placeholders.items()}
        pattern = "(" + "|".join(
            re.escape(k) for k in sorted(placeholders, key=len, reverse=True)) + ")"
        out: List[int] = []
        for part in re.split(pattern, frag, flags=re.IGNORECASE):
            learned = lowered.get(part.lower())
            if learned is not None:
                out.extend(learned)
            elif part:
                out.extend(tokenizer.encode_text(part))
        return out

    for frag, w in parse(text):
        frag_ids = frag_encode(frag)
        ids.extend(frag_ids)
        weights.extend([w] * len(frag_ids))
    if pad_token is None:
        pad_token = tokenizer.eot_id
    ids = ids[: length - 2]
    weights = weights[: length - 2]
    full_ids = ([tokenizer.sot_id] + ids + [tokenizer.eot_id]
                + [pad_token] * (length - 2 - len(ids)))
    full_w = [1.0] + weights + [1.0] * (length - 1 - len(weights))
    return full_ids, full_w
