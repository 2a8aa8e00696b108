"""WordNet synset helpers (reference utils/synset_utils.py), degradable; a
copy of `safevla_tpu/utils/synsets.py`.

With nltk + wordnet data installed these use real hypernym graphs; without,
they fall back to string-level behavior (a synset is its own only hypernym),
which keeps ObjectNav success logic functional on exact-synset matches.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Set, Union


def _wn():
    try:  # pragma: no cover - needs nltk data
        from nltk.corpus import wordnet as wn

        wn.synsets("dog")  # force-load; raises if the corpus is missing
        return wn
    except Exception:
        return None


@lru_cache(maxsize=10000)
def all_hypernyms(synset_str: str, include_self: bool = True) -> Set[str]:
    wn = _wn()
    if wn is None:
        return {synset_str} if include_self else set()
    synset = wn.synset(synset_str)
    out = {
        h.name()
        for path in synset.hypernym_paths()
        for h in path
        if include_self or h != synset
    }
    return out


@lru_cache(maxsize=10000)
def is_hypernym_of(synset_str: str, possible_hypernym: str) -> bool:
    return possible_hypernym in all_hypernyms(synset_str)


def broad_object_ids(
    synset_to_object_ids: dict, query_synset: str
) -> list:
    """Object ids of the query synset plus all hyponym entries present."""
    out = list(synset_to_object_ids.get(query_synset, []))
    for syn, ids in synset_to_object_ids.items():
        if syn != query_synset and is_hypernym_of(syn, query_synset):
            out.extend(ids)
    return out
