"""Self-contained rule-based grapheme<->phoneme machinery for English.

A copy of `nanowakeword_tpu/data/generator/g2p.py` (stdlib only).

The upstream nanowakeword relies on external pronunciation resources:
CMUdict via the `pronouncing` package and a downloaded neural phonemizer.
This rebuild ships a dependency-free rule G2P instead: longest-
match letter-cluster rules over an ARPAbet-like phone set, plus the reverse
phoneme->spelling map used to turn adversarial phoneme strings back into
synthesizable pseudo-words. Accuracy is approximate — which is fine: the
consumers are *adversarial* generators that deliberately perturb the result.
"""

from __future__ import annotations

import re
from typing import List

# Longest-match first. (pattern, phones) over lowercase words.
_G2P_RULES = [
    ("tion", ["SH", "AH", "N"]), ("sion", ["ZH", "AH", "N"]),
    ("ough", ["OW"]), ("augh", ["AE", "F"]), ("eigh", ["EY"]),
    ("tch", ["CH"]), ("dge", ["JH"]), ("igh", ["AY"]),
    ("sch", ["S", "K"]), ("squ", ["S", "K", "W"]),
    ("ch", ["CH"]), ("sh", ["SH"]), ("th", ["TH"]), ("ph", ["F"]),
    ("wh", ["W"]), ("ck", ["K"]), ("ng", ["NG"]), ("qu", ["K", "W"]),
    ("wr", ["R"]), ("kn", ["N"]), ("gn", ["N"]), ("mb", ["M"]),
    ("oo", ["UW"]), ("ee", ["IY"]), ("ea", ["IY"]), ("ai", ["EY"]),
    ("ay", ["EY"]), ("oa", ["OW"]), ("ow", ["OW"]), ("ou", ["AW"]),
    ("oi", ["OY"]), ("oy", ["OY"]), ("au", ["AO"]), ("aw", ["AO"]),
    ("ar", ["AA", "R"]), ("er", ["ER"]), ("ir", ["ER"]), ("ur", ["ER"]),
    ("or", ["AO", "R"]), ("ey", ["IY"]), ("ie", ["IY"]), ("ue", ["UW"]),
    ("a", ["AE"]), ("b", ["B"]), ("c", ["K"]), ("d", ["D"]),
    ("e", ["EH"]), ("f", ["F"]), ("g", ["G"]), ("h", ["HH"]),
    ("i", ["IH"]), ("j", ["JH"]), ("k", ["K"]), ("l", ["L"]),
    ("m", ["M"]), ("n", ["N"]), ("o", ["AA"]), ("p", ["P"]),
    ("r", ["R"]), ("s", ["S"]), ("t", ["T"]), ("u", ["AH"]),
    ("v", ["V"]), ("w", ["W"]), ("x", ["K", "S"]), ("y", ["Y"]),
    ("z", ["Z"]),
]

# Phone -> representative spelling, for converting perturbed phoneme strings
# back into pronounceable pseudo-words.
PHONE_TO_GRAPHEME = {
    "AA": "o", "AE": "a", "AH": "u", "AO": "aw", "AW": "ow", "AY": "igh",
    "EH": "e", "ER": "er", "EY": "ay", "IH": "i", "IY": "ee", "OW": "oa",
    "OY": "oy", "UH": "oo", "UW": "oo",
    "B": "b", "CH": "ch", "D": "d", "DH": "th", "F": "f", "G": "g",
    "HH": "h", "JH": "j", "K": "k", "L": "l", "M": "m", "N": "n",
    "NG": "ng", "P": "p", "R": "r", "S": "s", "SH": "sh", "T": "t",
    "TH": "th", "V": "v", "W": "w", "Y": "y", "Z": "z", "ZH": "zh",
}

VOWELS = {"AA", "AE", "AH", "AO", "AW", "AY", "EH", "ER", "EY", "IH", "IY",
          "OW", "OY", "UH", "UW"}

# Acoustic confusability groups (own design, mirroring the reference's
# hand-built map at adversarial_texts.py:343-402): phones within a group are
# plausible near-substitutes.
CONFUSABLE = {
    "P": ["B", "T", "K"], "B": ["P", "D", "G"], "T": ["D", "P", "K"],
    "D": ["T", "B", "G"], "K": ["G", "T", "P"], "G": ["K", "D", "B"],
    "CH": ["JH", "SH", "T"], "JH": ["CH", "ZH", "D"],
    "F": ["V", "TH", "S"], "V": ["F", "DH", "Z"],
    "TH": ["F", "S", "DH"], "DH": ["V", "Z", "TH"],
    "S": ["Z", "SH", "TH"], "Z": ["S", "ZH", "DH"],
    "SH": ["CH", "S", "ZH"], "ZH": ["SH", "Z", "JH"],
    "HH": ["F", "TH"], "M": ["N", "NG"], "N": ["M", "NG"],
    "NG": ["N", "M"], "L": ["R", "W"], "R": ["L", "W"],
    "W": ["R", "L", "V"], "Y": ["IY", "W"],
    "AA": ["AO", "AH", "AE"], "AE": ["EH", "AH", "AA"],
    "AH": ["AA", "ER", "UH"], "AO": ["AA", "OW", "UH"],
    "AW": ["OW", "AO", "AA"], "AY": ["EY", "OY", "IY"],
    "EH": ["AE", "IH", "EY"], "ER": ["AH", "UH", "OW"],
    "EY": ["IY", "EH", "AY"], "IH": ["IY", "EH", "AH"],
    "IY": ["IH", "EY", "Y"], "OW": ["AO", "UW", "AW"],
    "OY": ["AY", "OW", "IY"], "UH": ["UW", "AH", "AO"],
    "UW": ["UH", "OW", "IY"],
}


def clean_text(text: str) -> str:
    """Lowercase, strip everything but letters/spaces
    (adversarial_texts.py:63-72 contract)."""
    return re.sub(r"[^a-z\s]", "", text.lower()).strip()


def word_to_phones(word: str) -> List[str]:
    """Greedy longest-match rule G2P: one word -> phone list."""
    word = re.sub(r"[^a-z]", "", word.lower())
    # silent trailing 'e' heuristic
    if len(word) > 2 and word.endswith("e") and word[-2] not in "aeiou":
        word = word[:-1]
    phones: List[str] = []
    i = 0
    while i < len(word):
        for pattern, ph in _G2P_RULES:
            if word.startswith(pattern, i):
                phones.extend(ph)
                i += len(pattern)
                break
        else:
            i += 1  # unknown char, skip
    return phones


def text_to_phones(text: str) -> List[List[str]]:
    """Sentence -> list of per-word phone lists."""
    return [word_to_phones(w) for w in clean_text(text).split() if w]


def phones_to_word(phones: List[str]) -> str:
    """Phones -> pronounceable pseudo-word spelling."""
    return "".join(PHONE_TO_GRAPHEME.get(p, "") for p in phones)


def phone_distance(a: List[str], b: List[str]) -> float:
    """Normalised Levenshtein distance over phone sequences
    (adversarial_texts.py:457-495 contract)."""
    la, lb = len(a), len(b)
    if la == 0 or lb == 0:
        return 1.0 if la != lb else 0.0
    prev = list(range(lb + 1))
    for i in range(1, la + 1):
        cur = [i] + [0] * lb
        for j in range(1, lb + 1):
            cost = 0 if a[i - 1] == b[j - 1] else 1
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + cost)
        prev = cur
    return prev[lb] / max(la, lb)


def collapse_repeated_letters(text: str, max_repeat: int = 2) -> str:
    """Squash runs of >max_repeat identical letters
    (adversarial_texts.py:570 contract)."""
    return re.sub(r"(.)\1{%d,}" % max_repeat, r"\1" * max_repeat, text)
