"""PTB-style caption tokenization.

The port's copy of ``recurrent_fusion_network_tpu/metrics/tokenizer.py``.

The reference shells out to Stanford CoreNLP's PTBTokenizer (-lowerCase)
and then strips a fixed punctuation list
(coco-caption/pycocoevalcap/tokenizer/ptbtokenizer.py:21-68). This module
reproduces the OBSERVABLE pipeline effect in pure Python (no Java
subprocess), including the PTB rules that change token identity:

  * clitics split into their own tokens and SURVIVE the strip list
    ("dog's" -> dog 's ; "don't" -> do n't — "'s"/"n't" are not in
    PUNCTUATIONS, only the bare apostrophe is);
  * sentence punctuation . ? ! , : ; splits off and is stripped, while
    word-internal periods (u.s.) and hyphens (twenty-one) stay;
  * brackets become -LRB-/-RRB-/-LCB-/-RCB- and quotes become ``/'' in PTB —
    all on the strip list, so here they are removed directly;
  * -- and ... are standalone tokens, stripped.
"""

from __future__ import annotations

import re
from typing import Dict, List

# the PTBTokenizer strip list (ptbtokenizer.py:13-16)
PUNCTUATIONS = [
    "''", "'", "``", "`", "-LRB-", "-RRB-", "-LCB-", "-RCB-",
    ".", "?", "!", ",", ":", "-", "--", "...", ";",
]

_SPLIT = re.compile(r"[\s]+")
# PTB clitic suffixes, split into their own tokens (kept by the strip list)
_CLITIC = re.compile(r"(n't|'s|'m|'re|'ve|'ll|'d)$")
_BRACKET_QUOTE = re.compile(r"[\(\)\[\]\{\}\"]")
# , and : stay word-internal when DIGIT-flanked (CoreNLP keeps '1,000' and
# '4:30' as single tokens); elsewhere they split off like ; ? !
_STANDALONE = re.compile(r"(\.\.\.|--|[;\?\!]|(?<!\d)[,:]|[,:](?!\d))")
_STRIP_SET = frozenset(PUNCTUATIONS)


def tokenize_sentence(s: str) -> List[str]:
    s = s.replace("\n", " ").lower()
    # brackets/quotes become -LRB- etc. / ``'' in PTB, all stripped — remove
    s = _BRACKET_QUOTE.sub(" ", s)
    # standalone punctuation tokens (then stripped)
    s = _STANDALONE.sub(r" \1 ", s)
    out = []
    for tok in _SPLIT.split(s.strip()):
        if not tok:
            continue
        # sentence-final period splits off BEFORE clitic analysis (PTB
        # emits "dog 's ." — period-last order; stripping it after the
        # clitic check left "dog's." fused while mid-sentence "dog's"
        # split, so the same word never matched across positions);
        # abbreviation periods (u.s.) stay word-internal like PTB keeps them
        if len(tok) > 1 and tok.endswith(".") and "." not in tok[:-1]:
            tok = tok[:-1]
        if _CLITIC.fullmatch(tok):  # a bare clitic survives whole
            out.append(tok)
            continue
        # split a clitic suffix into its own (surviving) token
        m = _CLITIC.search(tok)
        if m and m.start() > 0:
            head, tail = tok[: m.start()], m.group()
        else:
            head, tail = tok, None
        # PTB renders quote-wrapped words as ` word ' (both stripped)
        head = head.strip("'`")
        if head and head not in _STRIP_SET:
            out.append(head)
        if tail is not None:
            out.append(tail)
    return out


def tokenize(captions: Dict, joined: bool = True) -> Dict:
    """Tokenize {key: [sentence or {'caption': sentence}, ...]} like the
    reference PTBTokenizer.tokenize — returns {key: [tokenized string, ...]}."""
    out = {}
    for k, sents in captions.items():
        rows = []
        for s in sents:
            if isinstance(s, dict):
                s = s["caption"]
            toks = tokenize_sentence(s)
            rows.append(" ".join(toks) if joined else toks)
        out[k] = rows
    return out
