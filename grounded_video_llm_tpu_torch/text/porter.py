# The port's own copy of grounded_video_llm_tpu/text/porter.py, which imports no
# framework; tests/test_torch_shared_modules.py holds the two to each other.
"""Porter stemmer — M.F. Porter, "An algorithm for suffix stripping",
Program 14(3) 1980. Implemented from the paper's published rule tables.

Used by serve/captioning.py's METEOR scorer: the official METEOR tool
(reference README.md:31-34 reports METEOR on ActivityNet-Captions) aligns
unigrams in stages exact → stem → synonym; the stem stage is this algorithm.
Porter stemming is pure code — unlike the WordNet synonym stage it needs no
data assets, so implementing it closes half of the documented deviation from
the Java scorer (serve/captioning.py module docstring).

Notation from the paper: a *consonant* is a letter other than a,e,i,o,u and
other than y preceded by a consonant (so y in "toy" is a consonant, y in
"syzygy" is a vowel; leading y is a consonant). A word has the form
[C](VC)^m[V]; m is its *measure*. Rules are grouped in steps; within a step
the LONGEST matching suffix wins (if its condition fails, no rule in the
step applies).
"""

from __future__ import annotations

_VOWELS = "aeiou"


def _cons(w: str, i: int) -> bool:
    c = w[i]
    if c in _VOWELS:
        return False
    if c == "y":
        return i == 0 or not _cons(w, i - 1)
    return True


def _measure(w: str) -> int:
    """m in [C](VC)^m[V]."""
    m, i, n = 0, 0, len(w)
    while i < n and _cons(w, i):
        i += 1
    while i < n:
        while i < n and not _cons(w, i):
            i += 1
        if i >= n:
            break
        m += 1
        while i < n and _cons(w, i):
            i += 1
    return m


def _has_vowel(w: str) -> bool:
    return any(not _cons(w, i) for i in range(len(w)))


def _double_cons(w: str) -> bool:
    return len(w) >= 2 and w[-1] == w[-2] and _cons(w, len(w) - 1)


def _cvc(w: str) -> bool:
    """*o: ends cvc where the final c is not w, x or y."""
    return (len(w) >= 3 and _cons(w, len(w) - 3) and not _cons(w, len(w) - 2)
            and _cons(w, len(w) - 1) and w[-1] not in "wxy")


def _rule(w: str, rules):
    """Longest-suffix-wins within a step: scan rules (suffix, repl, cond) in
    order of decreasing suffix length; the first suffix that MATCHES decides
    — if its condition fails the step leaves the word unchanged."""
    for suf, repl, cond in rules:
        if w.endswith(suf):
            stem = w[: len(w) - len(suf)]
            if cond is None or cond(stem):
                return stem + repl
            return w
    return w


def _m_gt0(s):
    return _measure(s) > 0


def _m_gt1(s):
    return _measure(s) > 1


_STEP2 = [  # paper's step 2 table, longest suffixes first
    ("ization", "ize", _m_gt0), ("iveness", "ive", _m_gt0),
    ("fulness", "ful", _m_gt0), ("ousness", "ous", _m_gt0),
    ("ational", "ate", _m_gt0), ("tional", "tion", _m_gt0),
    ("biliti", "ble", _m_gt0), ("ation", "ate", _m_gt0),
    ("alism", "al", _m_gt0), ("aliti", "al", _m_gt0),
    ("iviti", "ive", _m_gt0), ("ousli", "ous", _m_gt0),
    ("entli", "ent", _m_gt0), ("enci", "ence", _m_gt0),
    ("anci", "ance", _m_gt0), ("izer", "ize", _m_gt0),
    ("abli", "able", _m_gt0), ("alli", "al", _m_gt0),
    ("ator", "ate", _m_gt0), ("eli", "e", _m_gt0),
]

_STEP3 = [
    ("icate", "ic", _m_gt0), ("ative", "", _m_gt0), ("alize", "al", _m_gt0),
    ("iciti", "ic", _m_gt0), ("ical", "ic", _m_gt0), ("ness", "", _m_gt0),
    ("ful", "", _m_gt0),
]

_STEP4 = [
    ("ement", "", _m_gt1), ("ance", "", _m_gt1), ("ence", "", _m_gt1),
    ("able", "", _m_gt1), ("ible", "", _m_gt1), ("ment", "", _m_gt1),
    ("ant", "", _m_gt1), ("ent", "", _m_gt1),
    ("ion", "", lambda s: _m_gt1(s) and s[-1:] in ("s", "t")),
    ("ism", "", _m_gt1), ("ate", "", _m_gt1), ("iti", "", _m_gt1),
    ("ous", "", _m_gt1), ("ive", "", _m_gt1), ("ize", "", _m_gt1),
    ("al", "", _m_gt1), ("er", "", _m_gt1), ("ic", "", _m_gt1),
    ("ou", "", _m_gt1),
]


def porter_stem(word: str) -> str:
    w = word.lower()
    if len(w) <= 2:
        return w

    # Step 1a
    if w.endswith("sses"):
        w = w[:-2]
    elif w.endswith("ies"):
        w = w[:-2]
    elif not w.endswith("ss") and w.endswith("s"):
        w = w[:-1]

    # Step 1b
    if w.endswith("eed"):
        if _measure(w[:-3]) > 0:
            w = w[:-1]
    else:
        fired = False
        if w.endswith("ed") and _has_vowel(w[:-2]):
            w, fired = w[:-2], True
        elif w.endswith("ing") and _has_vowel(w[:-3]):
            w, fired = w[:-3], True
        if fired:
            if w.endswith(("at", "bl", "iz")):
                w += "e"
            elif _double_cons(w) and w[-1] not in "lsz":
                w = w[:-1]
            elif _measure(w) == 1 and _cvc(w):
                w += "e"

    # Step 1c
    if w.endswith("y") and _has_vowel(w[:-1]):
        w = w[:-1] + "i"

    w = _rule(w, _STEP2)
    w = _rule(w, _STEP3)
    w = _rule(w, _STEP4)

    # Step 5a
    if w.endswith("e"):
        stem = w[:-1]
        m = _measure(stem)
        if m > 1 or (m == 1 and not _cvc(stem)):
            w = stem
    # Step 5b
    if _measure(w) > 1 and _double_cons(w) and w.endswith("l"):
        w = w[:-1]
    return w
