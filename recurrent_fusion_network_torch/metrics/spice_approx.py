"""Approximate SPICE: pure-Python scene-graph tuple F-score (Java-free).

The port's copy of ``recurrent_fusion_network_tpu/metrics/spice_approx.py``,
the default SPICE column of ``coco_eval.evaluate_captions``. The reference
scores SPICE with the official spice-1.0.jar (a Stanford scene-graph-parser
pipeline; coco-caption/pycocoevalcap/spice/spice.py:27-97). This module is a
clearly-APPROXIMATE clean-room implementation of the SPICE metric definition
(Anderson et al. 2016):

  1. parse each caption into a scene graph — objects, (object, attribute)
     pairs, (subject, relation, object) triples — here via a rule-based
     chunker over the tokenized caption instead of a dependency parser;
  2. encode candidate and (union-of-)reference graphs as tuple sets;
  3. score F1 over synonym-aware tuple matching, overall ("All") and per
     category (Object / Attribute / Relation / Color / Cardinality / Size,
     the jar's -subset output).

Where it deviates from the jar (all documented in PARITY.md): the parser is
a closed-class-lexicon chunker, not CoreNLP; synonymy is a small built-in
caption-domain table (+ optional user-supplied SynonymTable) instead of
WordNet; lemmatization is rule-based. Both candidate and references pass
through the SAME normalizer, so systematic parse quirks largely cancel in
the F-score. Numbers are NOT the jar's numbers — treat them as a consistent
approximate SPICE column, not jar parity.

``SpiceApprox.compute_score(gts, res) -> (mean, per-sentence F list)``, with
``.last_details`` carrying the per-image category dict. The jar and HTTP
SPICE back ends are not ported (ROADMAP.md queue 1, M6 remainder).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

# --------------------------------------------------------------------------
# Closed-class lexicons (lowercase; captions are tokenized lowercase)

DETERMINERS = {
    "a", "an", "the", "this", "that", "these", "those", "some", "many",
    "few", "several", "no", "every", "each", "all", "both", "another",
    "other", "its", "his", "her", "their", "our", "my", "your", "any",
}
CARDINAL_WORDS = {
    "one": "1", "two": "2", "three": "3", "four": "4", "five": "5",
    "six": "6", "seven": "7", "eight": "8", "nine": "9", "ten": "10",
    "eleven": "11", "twelve": "12",
}
PREPOSITIONS = {
    "in", "on", "at", "with", "near", "over", "under", "above", "below",
    "behind", "by", "beside", "between", "through", "across", "inside",
    "outside", "into", "onto", "along", "around", "against", "atop",
    "beneath", "underneath", "toward", "towards", "upon", "off", "from",
    "down", "up", "within", "amid", "among", "past", "beyond", "next",
    "of", "to", "during",
}
COPULAS = {"is", "are", "was", "were", "be", "being", "been", "am"}
AUXILIARIES = {
    "has", "have", "had", "do", "does", "did", "can", "could", "will",
    "would", "may", "might", "must", "should", "shall",
}
CONJUNCTIONS = {"and", "or"}
RELATIVES = {"that", "which", "who", "whom", "whose"}
CLAUSE_BREAKERS = {"while", "as"}  # start a fresh clause/subject
# -s words that are (almost always) clause-final intransitive verbs in
# captions ("... while a woman watches"), never NP heads
CLAUSE_FINAL_VERBS = {
    "watches", "looks", "waits", "smiles", "sits", "stands", "sleeps",
    "rests", "poses", "plays", "eats", "runs", "sets", "grazes",
}
PRONOUNS = {
    "it", "he", "she", "they", "him", "them", "there", "here", "what",
    "something", "someone", "itself", "himself", "herself", "themselves",
}
# skipped entirely (intensifiers/negation/discourse)
SKIP_WORDS = {
    "very", "really", "quite", "not", "n't", "just", "also", "only",
    "'s", "'", ",", ".", ";", ":", "!", "?", "-", "--",
}

# light locative nouns that fold into compound prepositions
# ("on top of", "in front of"): the scene-graph parser treats them as part
# of the relation, not as objects
LIGHT_NOUNS = {
    "top", "front", "side", "middle", "back", "bottom", "edge", "end",
    "center", "rear",
}

COLORS = {
    "red", "orange", "yellow", "green", "blue", "purple", "pink", "brown",
    "black", "white", "gray", "grey", "golden", "gold", "silver", "tan",
    "beige", "maroon", "teal", "turquoise", "violet", "colorful",
}
SIZES = {
    "big", "large", "small", "tiny", "huge", "little", "tall", "short",
    "long", "wide", "narrow", "giant", "enormous", "massive", "mini",
    "oversized", "miniature",
}

# irregular noun lemmas (plural -> singular)
IRREGULAR_NOUNS = {
    "men": "man", "women": "woman", "children": "child", "feet": "foot",
    "teeth": "tooth", "geese": "goose", "mice": "mouse", "leaves": "leaf",
    "knives": "knife", "wolves": "wolf", "shelves": "shelf",
    "loaves": "loaf", "scarves": "scarf", "wives": "wife",
    "lives": "life", "halves": "half", "calves": "calf",
}
# words ending in -ing that are (almost always) nouns in captions
ING_NOUNS = {
    "building", "buildings", "painting", "paintings", "ceiling", "clothing",
    "railing", "awning", "frosting", "icing", "lightning", "landing",
    "crossing", "dressing", "topping", "toppings", "ring", "rings",
    "string", "strings", "wing", "wings", "king", "kings", "thing",
    "things", "spring", "swing", "morning", "evening", "wedding",
}
# small caption-domain synonym groups (standing in for WordNet synsets;
# extensible via a user-supplied metrics.meteor.SynonymTable)
BUILTIN_SYNONYM_GROUPS = [
    ["person", "people", "human"],
    ["photo", "photograph", "picture", "image"],
    ["bike", "bicycle"],
    ["motorcycle", "motorbike"],
    ["car", "automobile"],
    ["couch", "sofa"],
    ["tv", "television"],
    ["kid", "child"],
    ["cellphone", "phone", "telephone"],
    ["sidewalk", "pavement"],
    ["street", "road"],
    ["store", "shop"],
    ["sneaker", "shoe"],
    ["cap", "hat"],
    ["big", "large"],
    ["small", "little"],
    ["near", "beside", "by", "next"],
]


def _lemma_noun(w: str) -> str:
    if w in IRREGULAR_NOUNS:
        return IRREGULAR_NOUNS[w]
    if len(w) > 4 and w.endswith("ies"):
        return w[:-3] + "y"
    if len(w) > 4 and w.endswith(("ches", "shes", "xes", "zes", "sses")):
        return w[:-2]
    if len(w) > 3 and w.endswith("s") and not w.endswith(("ss", "us", "is")):
        return w[:-1]
    return w


_VOWELS = set("aeiou")

# inflected form -> base for verbs the CVC heuristics below misjudge
IRREGULAR_VERBS = {
    "lying": "lie", "dying": "die", "tying": "tie",
    "balancing": "balance", "balanced": "balance",
    "bouncing": "bounce", "bounced": "bounce",
    "chasing": "chase", "chased": "chase",
    "practicing": "practice", "practiced": "practice",
    "racing": "race", "raced": "race",
    "serving": "serve", "served": "serve",
    "carving": "carve", "carved": "carve",
    "observing": "observe",
    "exercising": "exercise",
}


def _vowel_groups(w: str) -> int:
    n, prev = 0, False
    for ch in w:
        v = ch in _VOWELS
        if v and not prev:
            n += 1
        prev = v
    return n


def _lemma_verb(w: str) -> str:
    """Rule-based -ing/-ed/-s verb base form ('riding'->'ride',
    'sitting'->'sit', 'parked'->'park', 'walks'->'walk')."""
    if w in IRREGULAR_VERBS:
        return IRREGULAR_VERBS[w]
    for suf in ("ing", "ed"):
        if len(w) > len(suf) + 2 and w.endswith(suf):
            stem = w[: -len(suf)]
            if (len(stem) >= 3 and stem[-1] == stem[-2]
                    and stem[-1] not in "lsz"):
                return stem[:-1]  # sitting -> sit
            if (len(stem) >= 3 and stem[-1] not in _VOWELS
                    and stem[-1] not in "wxy" and stem[-2] in _VOWELS
                    and stem[-3] not in _VOWELS
                    and _vowel_groups(stem) == 1):
                # the silent-e restore applies to one-syllable CVC stems
                # only ('riding'->'ride', 'grazing'->'graze'); multi-
                # syllable stems with an unstressed final syllable keep
                # their form ('traveling'->'travel', 'visited'->'visit')
                return stem + "e"
            return stem
    if len(w) > 3 and w.endswith("s") and not w.endswith("ss"):
        return w[:-1]
    return w


def _is_verb_like(w: str) -> bool:
    if w in ING_NOUNS:
        return False
    return (len(w) > 4 and w.endswith("ing")) or (
        len(w) > 3 and w.endswith("ed")
    )


def _is_adverb(w: str) -> bool:
    return len(w) > 3 and w.endswith("ly") and w not in {
        "family", "jelly", "belly", "lily", "holly", "butterfly", "fly",
        "assembly", "rally",
    }


class SceneGraph:
    """Tuple sets extracted from one caption (all words lemmatized)."""

    def __init__(self):
        self.objects: Set[Tuple[str]] = set()
        self.attributes: Set[Tuple[str, str]] = set()
        self.relations: Set[Tuple[str, str, str]] = set()

    def tuples(self) -> Set[tuple]:
        return self.objects | self.attributes | self.relations

    def merge(self, other: "SceneGraph") -> None:
        self.objects |= other.objects
        self.attributes |= other.attributes
        self.relations |= other.relations


def parse_scene_graph(sentence_or_tokens) -> SceneGraph:
    """Rule-based chunker: tokenized caption -> SceneGraph.

    Grammar heuristic tuned to caption English ("a young girl standing on
    top of a tennis court"): determiner-delimited noun phrases whose last
    content word is the head and earlier ones are attribute modifiers;
    -ing/-ed words outside an NP-initial position act as relation verbs
    (optionally absorbing a following preposition: 'sitting on'); bare
    prepositions relate the current subject group to the next NP head;
    copulas promote a trailing bare modifier to an attribute; conjunctions
    distribute relations over grouped heads.
    """
    if isinstance(sentence_or_tokens, str):
        tokens = sentence_or_tokens.lower().split()
    else:
        tokens = [t.lower() for t in sentence_or_tokens]

    g = SceneGraph()

    # current NP accumulation
    np_words: List[str] = []  # content words of the open NP
    np_nums: List[str] = []  # cardinal modifiers of the open NP
    in_np = False  # an NP is open (DET seen or content word consumed)

    subjects: List[str] = []  # current subject head group
    objects_grp: List[str] = []  # heads consumed by the pending relation
    pending_rel: Optional[str] = None  # verb/prep awaiting its object NP
    rel_anchor: List[str] = subjects  # heads the pending relation emits from
    rel_is_verb = False  # pending_rel came from a verb (may absorb a prep)
    rel_passive = False  # pending_rel is an -ed participle ("painted")
    after_cop = False  # immediately after a copula
    clause_done = False  # a copular attribute completed this clause

    def close_np() -> Optional[str]:
        """Emit the open NP's tuples; returns its head (lemmatized)."""
        nonlocal np_words, np_nums, in_np
        if not np_words:
            # a bare cardinal NP ("two of them") — drop
            np_words, np_nums, in_np = [], [], False
            return None
        head = _lemma_noun(np_words[-1])
        g.objects.add((head,))
        for mod in np_words[:-1]:
            m = _lemma_verb(mod) if _is_verb_like(mod) else _lemma_noun(mod)
            g.attributes.add((head, m))
        for num in np_nums:
            g.attributes.add((head, num))
        np_words, np_nums, in_np = [], [], False
        return head

    def finish_np_into_role():
        """Close the NP and attach its head as subject or relation object."""
        nonlocal pending_rel, rel_is_verb, subjects, objects_grp, after_cop
        nonlocal np_words, np_nums, in_np
        # passive participle whose whole "object" is color/size adjectives:
        # "painted red and white" / "colored blue" are predicative — the
        # scene-graph convention emits attributes, not a relation to an
        # adjective pseudo-object
        if (pending_rel is not None and rel_passive and np_words
                and not np_nums
                and all(m in COLORS or m in SIZES for m in np_words)):
            for s in rel_anchor:
                for m in np_words:
                    g.attributes.add((s, m))
            np_words, np_nums, in_np = [], [], False
            pending_rel, rel_is_verb = None, False  # participle consumed
            return
        head = close_np()
        if head is None:
            return
        if pending_rel is not None:
            for s in rel_anchor:
                g.relations.add((s, pending_rel, head))
            objects_grp.append(head)
        else:
            subjects.append(head)
        after_cop = False

    i = 0
    n = len(tokens)
    while i < n:
        w = tokens[i]
        if w in ("has", "have", "had") and (np_words or subjects):
            peek = tokens[i + 1] if i + 1 < n else None
            if peek is not None and not _is_verb_like(peek) \
                    and peek not in COPULAS and peek not in AUXILIARIES:
                # possession verb ("the kitchen has white cabinets" ->
                # kitchen-have-cabinet), not a perfect auxiliary
                # ("has been parked" / "has parked")
                if np_words:
                    finish_np_into_role()
                pending_rel, rel_is_verb = "have", False
                rel_passive = False
                rel_anchor = subjects
                objects_grp = []
                after_cop = False
                i += 1
                continue
        if w in SKIP_WORDS or w in AUXILIARIES or _is_adverb(w):
            i += 1
            continue
        if w in CARDINAL_WORDS or w.isdigit():
            num = CARDINAL_WORDS.get(w, w)
            np_nums.append(num)
            in_np = True
            i += 1
            continue
        if w in DETERMINERS:
            if w == "that":
                # "that" is a determiner ("that car") OR a relative pronoun
                # ("a cake that has candles"); a following verb/aux/copula
                # marks the relative reading
                peek = tokens[i + 1] if i + 1 < n else None
                if peek is not None and (
                    peek in AUXILIARIES or peek in COPULAS
                    or _is_verb_like(peek) or peek in CLAUSE_FINAL_VERBS
                ):
                    if np_words:
                        finish_np_into_role()
                    if objects_grp:
                        subjects = [objects_grp[-1]]  # relativized head
                    pending_rel, rel_is_verb = None, False
                    i += 1
                    continue
            if np_words:
                finish_np_into_role()
            in_np = True
            i += 1
            continue
        if w in COPULAS:
            if np_words:
                finish_np_into_role()
            after_cop = True
            # objects of any earlier relation can't continue past a copula
            pending_rel, rel_is_verb = None, False
            i += 1
            continue
        if w in CONJUNCTIONS:
            # modifier conjunction inside an NP ("a black and white cat"):
            # everything so far is adjective-like, so keep the NP open.
            # len cap: re-scanning the open NP per conjunction is O(n^2)
            # on an adversarial "red and red and ..." caption; real NPs
            # never carry 32 modifiers, so past that just close the NP.
            if np_words and len(np_words) < 32 and all(
                m in COLORS or m in SIZES or _is_verb_like(m)
                for m in np_words
            ):
                i += 1
                continue
            if np_words:
                finish_np_into_role()
            elif clause_done:
                # sentence-level coordination after a completed copular
                # clause ("the bananas are yellow and the apples are red"):
                # the next NP starts a FRESH subject group, it does not
                # join the attributed one
                subjects = []
                clause_done = False
            # grouped heads: subsequent NP joins the same role
            i += 1
            continue
        if w in RELATIVES:
            if np_words:
                finish_np_into_role()
            # relative clause: the verb that follows applies to the
            # relativized head — the most recent object NP if one exists
            # ("a cake that has candles" -> cake-have-candle), else the
            # current subjects
            if objects_grp:
                subjects = [objects_grp[-1]]
            pending_rel, rel_is_verb = None, False
            i += 1
            continue
        if w in CLAUSE_BREAKERS:
            # "... while a woman watches": a fresh clause with a fresh
            # subject group
            if np_words:
                finish_np_into_role()
            subjects = []
            objects_grp = []
            pending_rel, rel_is_verb = None, False
            clause_done = False
            i += 1
            continue
        if w in PREPOSITIONS:
            # compound preposition: "<rel> top of", "<rel> front of" —
            # the light noun belongs to the relation, not the graph
            if (w == "of" and len(np_words) == 1 and not np_nums
                    and np_words[0] in LIGHT_NOUNS
                    and pending_rel is not None and not objects_grp):
                pending_rel = f"{pending_rel} {np_words[0]} of"
                np_words, np_nums, in_np = [], [], False
                i += 1
                continue
            if np_words:
                finish_np_into_role()
            if rel_is_verb and pending_rel is not None and not objects_grp:
                # verb absorbing its particle(s): "sitting on" -> "sit on",
                # "parked next to" -> "park next to"
                pending_rel = f"{pending_rel} {w}"
            elif (pending_rel is not None and not objects_grp
                    and not np_words):
                # bare compound preposition ("next to", "up to"): a second
                # preposition with no NP in between extends the first,
                # keeping its anchor
                pending_rel = f"{pending_rel} {w}"
            else:
                # new prepositional relation. Most prepositions re-anchor
                # to the subject group ("... riding a horse on a beach" ->
                # man-on-beach, the scene-graph convention); partitive/
                # possessive "of" instead attaches to the NEAREST preceding
                # NP head ("a slice of cake" -> slice-of-cake even after
                # "a child eating a slice of cake")
                if w == "of" and objects_grp:
                    rel_anchor = [objects_grp[-1]]  # nearest NP head only
                else:
                    rel_anchor = subjects
                pending_rel, rel_is_verb = w, False
                rel_passive = False
                objects_grp = []
            after_cop = False
            i += 1
            continue
        if w in PRONOUNS:
            i += 1
            continue
        peek = tokens[i + 1] if i + 1 < n else None
        if w == "full" and peek == "of" and (np_words or subjects):
            # adjectival relation: "a bookshelf full of books" ->
            # bookshelf-full of-book (the "of" that follows is absorbed by
            # the rel_is_verb particle rule)
            if np_words:
                finish_np_into_role()
            pending_rel, rel_is_verb, rel_passive = "full", True, False
            rel_anchor = subjects
            objects_grp = []
            after_cop = False
            i += 1
            continue
        # third-person verb ('a man rides a bike'): an -s word right after
        # an NP head, introducing a new determiner phrase — or a known
        # clause-final intransitive ('... while a woman watches')
        third_person = (
            len(w) > 3 and w.endswith("s")
            and not w.endswith(("ss", "us", "is"))
            and bool(np_words)
            and (peek in DETERMINERS or peek in CARDINAL_WORDS
                 or (peek is None and w in CLAUSE_FINAL_VERBS))
        )
        if (_is_verb_like(w) or third_person) and (
            np_words or subjects
        ) and not (in_np and not np_words):
            # a verb: 'a man riding ...' (NP open with a head) or
            # 'the man is running' (after copula, subjects set);
            # NOT NP-initial position right after a determiner
            # ('a running man' keeps 'running' as modifier below)
            if np_words:
                finish_np_into_role()
            pending_rel, rel_is_verb = _lemma_verb(w), True
            rel_passive = w.endswith("ed")
            rel_anchor = subjects
            objects_grp = []
            after_cop = False
            i += 1
            continue
        # plain content word
        if after_cop and not in_np:
            # 'the shirt is red' -> attribute on each subject
            mod = _lemma_verb(w) if _is_verb_like(w) else _lemma_noun(w)
            peek = tokens[i + 1] if i + 1 < n else None
            if peek is None or peek in SKIP_WORDS or peek in PREPOSITIONS \
                    or peek in CONJUNCTIONS or peek in COPULAS:
                for s in subjects:
                    g.attributes.add((s, mod))
                clause_done = True
                i += 1
                continue
            # more content follows: treat as the start of a predicate NP
            in_np = True
        np_words.append(w)
        in_np = True
        i += 1
    if np_words:
        finish_np_into_role()
    return g


# --------------------------------------------------------------------------
# Scoring

_CATEGORIES = ("Object", "Attribute", "Relation", "Color", "Cardinality",
               "Size")


def _category_subset(tuples: Set[tuple], cat: str) -> Set[tuple]:
    if cat == "Object":
        return {t for t in tuples if len(t) == 1}
    if cat == "Attribute":
        return {t for t in tuples if len(t) == 2}
    if cat == "Relation":
        return {t for t in tuples if len(t) == 3}
    if cat == "Color":
        return {t for t in tuples if len(t) == 2 and t[1] in COLORS}
    if cat == "Cardinality":
        return {t for t in tuples if len(t) == 2 and t[1].isdigit()}
    if cat == "Size":
        return {t for t in tuples if len(t) == 2 and t[1] in SIZES}
    raise ValueError(cat)


class _Matcher:
    """Synonym-aware tuple matching (built-in groups + optional user
    SynonymTable, the same format as METEOR's, metrics/meteor.py)."""

    def __init__(self, synonyms=None):
        import os

        from .meteor import SynonymTable, load_synonyms

        # the word->group-set index IS SynonymTable's job — reuse it for
        # the builtin groups rather than keeping a second implementation
        self._builtin = SynonymTable(BUILTIN_SYNONYM_GROUPS)
        if synonyms is None:
            # no-code-change upgrade path: point RFNET_SPICE_SYNONYMS at a
            # WordNet dict/ directory, data.* file, wn_s.pl, or a plain
            # groups file (load_synonyms sniffs the format)
            path = os.environ.get("RFNET_SPICE_SYNONYMS")
            if path and os.path.exists(path):
                synonyms = load_synonyms(path)
        elif isinstance(synonyms, str):
            synonyms = load_synonyms(synonyms)
        self._user = synonyms  # SynonymTable-like (.related) or None

    def words_match(self, a: str, b: str) -> bool:
        if a == b:
            return True
        if self._builtin.related(a, b):
            return True
        return bool(self._user is not None and self._user.related(a, b))

    def tuples_match(self, t1: tuple, t2: tuple) -> bool:
        return len(t1) == len(t2) and all(
            self.words_match(a, b) for a, b in zip(t1, t2)
        )

    def count_matches(self, cand: Set[tuple], ref: Set[tuple]) -> int:
        """MAXIMUM bipartite matching (Kuhn's augmenting paths) over sorted
        tuple lists. Greedy set-iteration was both nondeterministic (set
        order varies with PYTHONHASHSEED, so the same corpus scored
        differently per process) and an undercount when a tuple with many
        synonym partners grabbed a reference another tuple needed —
        synonym relations are NOT transitive, so matching is a real
        bipartite problem. Per-caption tuple sets are tiny (tens), so
        O(V*E) is nothing."""
        cand_l = sorted(cand)
        ref_l = sorted(ref)
        adj = [
            [j for j, r in enumerate(ref_l) if self.tuples_match(t, r)]
            for t in cand_l
        ]
        match_r = [-1] * len(ref_l)

        def augment(i, seen):
            for j in adj[i]:
                if j in seen:
                    continue
                seen.add(j)
                if match_r[j] < 0 or augment(match_r[j], seen):
                    match_r[j] = i
                    return True
            return False

        return sum(augment(i, set()) for i in range(len(cand_l)))


def _prf(cand: Set[tuple], ref: Set[tuple], matcher: _Matcher):
    m = matcher.count_matches(cand, ref)
    p = m / len(cand) if cand else 0.0
    r = m / len(ref) if ref else 0.0
    f = 2 * p * r / (p + r) if (p + r) > 0 else 0.0
    # the jar emits NaN for an undefined category (no tuples either side)
    if not cand and not ref:
        p = r = f = float("nan")
    return {"pr": p, "re": r, "f": f}


def score_pair(test: str, refs: Sequence[str], *, synonyms=None,
               matcher: Optional[_Matcher] = None) -> Dict:
    """One image: candidate sentence vs reference list -> the jar's per-image
    scores dict {'All': {'f','pr','re'}, 'Object': ..., ...}.

    Batch callers pass a shared `matcher` so the synonym-group index is
    built once per corpus, not once per image."""
    if matcher is None:
        matcher = _Matcher(synonyms)
    cand = parse_scene_graph(test).tuples()
    ref_graph = SceneGraph()
    for r in refs:
        ref_graph.merge(parse_scene_graph(r))
    ref = ref_graph.tuples()
    scores = {"All": _prf(cand, ref, matcher)}
    for cat in _CATEGORIES:
        scores[cat] = _prf(
            _category_subset(cand, cat), _category_subset(ref, cat), matcher
        )
    return scores


class SpiceApprox:
    """Drop-in SPICE scorer with the reference compute_score contract
    (spice.py:27-97): (mean All-F, per-sentence F list in string-sorted
    image-id order), per-image category details on .last_details."""

    def __init__(self, synonyms=None):
        self.synonyms = synonyms
        self.last_details = None

    def compute_score(self, gts: Dict, res: Dict):
        assert sorted(gts.keys(), key=str) == sorted(res.keys(), key=str)
        image_ids = sorted(res.keys(), key=str)
        matcher = _Matcher(self.synonyms)  # one synonym index per corpus
        sent, details = [], {}
        for image_id in image_ids:
            hypo, refs = res[image_id], gts[image_id]
            assert isinstance(hypo, list) and len(hypo) == 1
            assert isinstance(refs, list) and len(refs) >= 1
            scores = score_pair(hypo[0], refs, matcher=matcher)
            sent.append(scores["All"]["f"])
            details[image_id] = scores
        self.last_details = details
        mean = float(np.nanmean(np.asarray(sent))) if sent else 0.0
        return mean, sent

