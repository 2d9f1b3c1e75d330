"""Adversarial text generation: phonetically-confusable negative phrases.

A copy of `nanowakeword_tpu/data/generator/adversarial_texts.py` (stdlib
only). Two generators with upstream nanowakeword's call surface
(`adversarial_texts.py` there):

* `adversarial_texts(input_text, N, ...)` (`:102-330`): word-level
  near-homophones assembled into phrases, with partial-phrase and
  keep-original-word probabilities, multi-word embedding among filler words,
  and auto-relaxation after repeated duplicate failures.
* `PhonemeAdversarialGenerator` (`:333-543`): phoneme-level perturbation —
  substitute 35-60% of phones using a confusability map, keep variants whose
  normalised phone distance >= min_distance, respell to pseudo-words.

Self-contained rebuild: the reference needs CMUdict (`pronouncing`) and a
downloaded neural phonemizer; here both run on the rule G2P in g2p.py with
zero network or model assets. `get_phonemizer_model` is kept for API parity
and returns the rule engine.
"""

from __future__ import annotations

import random
from typing import List, Optional

from nanowakeword_tpu_torch.data.generator.g2p import (
    CONFUSABLE, VOWELS, clean_text, collapse_repeated_letters, phone_distance,
    phones_to_word, text_to_phones, word_to_phones)

# Common filler words for multi-word embedding (the reference samples from
# CMUdict; a compact high-frequency list works as well for assembling
# natural-sounding negative phrases).
_FILLER_WORDS = [
    "the", "about", "over", "under", "before", "after", "maybe", "really",
    "today", "never", "always", "little", "around", "because", "people",
    "again", "another", "morning", "evening", "question", "answer", "window",
    "garden", "yellow", "river", "mountain", "station", "coffee", "dinner",
    "paper", "music", "happy", "sudden", "quiet", "open", "close", "better",
    "number", "second", "minute", "story", "summer", "winter", "corner",
    "follow", "wonder", "listen", "remember", "different", "important",
]


class _DedupTracker:
    """Duplicate suppression with auto-relaxation after 50 consecutive
    failures (adversarial_texts.py:102-330 behaviour)."""

    def __init__(self, limit: int = 50):
        self.seen = set()
        self.failures = 0
        self.limit = limit
        self.relaxed = False

    def admit(self, text: str) -> bool:
        if self.relaxed:
            return True
        if text in self.seen:
            self.failures += 1
            if self.failures >= self.limit:
                self.relaxed = True
            return False
        self.seen.add(text)
        self.failures = 0
        return True


def _perturb_word(word: str, rng: random.Random,
                  sub_fraction: float = 0.45) -> str:
    """One near-homophone of `word` via confusable phone substitution."""
    phones = word_to_phones(word)
    if not phones:
        return word
    n_subs = max(1, round(len(phones) * sub_fraction * rng.uniform(0.6, 1.4)))
    idxs = rng.sample(range(len(phones)), min(n_subs, len(phones)))
    out = list(phones)
    for i in idxs:
        options = CONFUSABLE.get(out[i])
        if options:
            out[i] = rng.choice(options)
    return phones_to_word(out) or word


def adversarial_texts(input_text: str, N: int = 100,
                      include_input_words: bool = True,
                      include_partial_phrase: bool = True,
                      multi_word_prob: float = 0.5,
                      max_multi_word_len: int = 3,
                      partial_phrase_prob: float = 0.3,
                      keep_word_prob: float = 0.25,
                      seed: Optional[int] = 10) -> List[str]:
    """Word-level adversarial phrase generation
    (adversarial_texts.py:102-330 call surface).

    Args:
        input_text: the wake phrase to attack.
        N: number of phrases to produce.
        include_input_words: allow keeping some original words unchanged.
        include_partial_phrase: sometimes emit only a subset of the words.
        multi_word_prob: probability of embedding the result among fillers.
        max_multi_word_len: max filler words added on each side.
    """
    rng = random.Random(seed)
    words = clean_text(input_text).split()
    if not words:
        return []

    dedup = _DedupTracker()
    out: List[str] = []
    attempts = 0
    while len(out) < N and attempts < N * 30:
        attempts += 1
        chosen = list(words)
        if include_partial_phrase and len(words) > 1 \
                and rng.random() < partial_phrase_prob:
            k = rng.randint(1, len(words) - 1)
            start = rng.randint(0, len(words) - k)
            chosen = words[start:start + k]

        phrase_words = []
        for w in chosen:
            if include_input_words and rng.random() < keep_word_prob \
                    and len(chosen) > 1:
                phrase_words.append(w)
            else:
                phrase_words.append(_perturb_word(w, rng))
        phrase = " ".join(phrase_words)

        if rng.random() < multi_word_prob:
            before = rng.sample(_FILLER_WORDS,
                                rng.randint(0, max_multi_word_len))
            after = rng.sample(_FILLER_WORDS,
                               rng.randint(0, max_multi_word_len))
            phrase = " ".join(before + [phrase] + after).strip()

        phrase = collapse_repeated_letters(phrase)
        if phrase and phrase != clean_text(input_text) and dedup.admit(phrase):
            out.append(phrase)
    return out


def get_phonemizer_model(model_path: Optional[str] = None):
    """API-parity shim (adversarial_texts.py:544-567): the reference downloads
    a neural phonemizer; this build returns the built-in rule G2P."""
    return text_to_phones


class PhonemeAdversarialGenerator:
    """Phoneme-level hard negatives (adversarial_texts.py:333-543)."""

    def __init__(self, phonemizer_model=None, min_distance: float = 0.35,
                 min_sub_fraction: float = 0.35,
                 max_sub_fraction: float = 0.60, seed: int = 10):
        self.phonemize = phonemizer_model or text_to_phones
        self.min_distance = float(min_distance)
        self.min_sub = min_sub_fraction
        self.max_sub = max_sub_fraction
        self.rng = random.Random(seed)

    def calculate_distance(self, phones_a, phones_b) -> float:
        flat_a = [p for word in phones_a for p in word]
        flat_b = [p for word in phones_b for p in word]
        return phone_distance(flat_a, flat_b)

    def _perturb(self, word_phones: List[List[str]]) -> List[List[str]]:
        flat = [(wi, pi) for wi, word in enumerate(word_phones)
                for pi in range(len(word))]
        if not flat:
            return word_phones
        frac = self.rng.uniform(self.min_sub, self.max_sub)
        n_subs = max(1, round(len(flat) * frac))
        targets = self.rng.sample(flat, min(n_subs, len(flat)))
        out = [list(w) for w in word_phones]
        for wi, pi in targets:
            phone = out[wi][pi]
            options = CONFUSABLE.get(phone)
            if not options:
                continue
            # occasionally delete a consonant or stretch a vowel instead
            roll = self.rng.random()
            if roll < 0.1 and phone not in VOWELS and len(out[wi]) > 2:
                out[wi][pi] = ""
            else:
                out[wi][pi] = self.rng.choice(options)
        return [[p for p in w if p] for w in out]

    def generate(self, base_phrase: str, num_samples: int) -> List[str]:
        base_phones = self.phonemize(base_phrase)
        dedup = _DedupTracker()
        variants: List[str] = []
        attempts = 0
        while len(variants) < num_samples and attempts < num_samples * 40:
            attempts += 1
            perturbed = self._perturb(base_phones)
            dist = self.calculate_distance(base_phones, perturbed)
            if dist < self.min_distance:
                continue
            text = " ".join(phones_to_word(w) for w in perturbed if w).strip()
            if text and dedup.admit(text):
                variants.append(text)
        return variants
