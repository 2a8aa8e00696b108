"""Task spec -> natural-language instruction templates.

The port's copy of `safevla_tpu/utils/instructions.py` (counterpart of
reference utils/task_spec_to_instruction.py): templated instructions per
task type built from verb lists + synset lemmas. The same templates and the
same draws from the global `random`, so a seeded run picks the same words.
Lemma resolution degrades gracefully: WordNet (when nltk data is installed)
-> synset-string parsing ("coffee_mug.n.01" -> "coffee mug"). Determiner
choice falls back to first-letter vowels when no phonemizer is present
(the reference has the identical fallback, task_spec_to_instruction.py:137-142).
"""

from __future__ import annotations

import random
from functools import lru_cache
from typing import Any, Dict

GOTO_VERBS = ["go to", "locate", "find", "search for", "navigate to"]
PICKUP_VERBS = ["pick up", "take", "grab", "grasp", "clutch", "hold"]
GOTO_POINT_VERBS = ["go to", "navigate to"]


@lru_cache(maxsize=None)
def best_lemma(synset_str: str) -> str:
    """Most specific lemma for a synset, with a parse fallback."""
    try:  # pragma: no cover - needs nltk wordnet data
        from nltk.corpus import wordnet as wn

        synset = wn.synset(synset_str)
        names = synset.lemma_names()
        if names:
            return min(names, key=lambda ln: len(wn.synsets(ln, pos=wn.NOUN)) or 1)
    except Exception:
        pass
    return synset_str.split(".")[0]


def normalize(text: str) -> str:
    if ".n." in text:
        text = best_lemma(text)
    return text.strip().lower().replace("_", " ").strip().strip(".;/,'\"\\")


@lru_cache(maxsize=None)
def find_det(word: str) -> str:
    return "an" if word[:1] in "aeiou" else "a"


def choose_det(text: str) -> str:
    return f"{find_det(normalize(text).split()[0])} {text}"


def make_source_obj(task_params: Dict[str, Any]) -> str:
    if "synsets" not in task_params:
        target = task_params.get("target_object_type") or task_params["object_types"][0]
        return normalize(target)
    return normalize(task_params["synsets"][0])


def make_room(task_params: Dict[str, Any]) -> str:
    return normalize(f"in the {normalize(task_params['room_type'])}")


def make_rel_attribute(task_params: Dict[str, Any]) -> str:
    obj = make_source_obj(task_params)
    rel = task_params["rel_attribute"]
    if isinstance(rel, (tuple, list)):
        from_to = "to" if normalize(rel[0]) in ("closest",) else "from"
        return f"{obj} {normalize(rel[0])} {from_to} the {normalize(rel[1])}"
    return f"{normalize(rel)} {obj}"


def make_local_ref(task_params: Dict[str, Any]) -> str:
    refs = task_params["reference_synsets"]
    if task_params["reference_type"] == "near":
        return normalize(
            f"near {choose_det(normalize(refs[0]))} and {choose_det(normalize(refs[1]))}"
        )
    if task_params["reference_type"] == "on":
        return normalize(f"on {choose_det(normalize(refs[0]))}")
    raise NotImplementedError(task_params["reference_type"])


def make_affordance(task_params: Dict[str, Any]) -> str:
    return normalize(
        f"{normalize(task_params['synsets'][0])} that can best be used for "
        f"{normalize(task_params['affordance'])}"
    )


# ---------------------------------------------------------------------------


def object_nav_type(p):
    return normalize(f"{random.choice(GOTO_VERBS)} {choose_det(make_source_obj(p))}")


def object_nav_room(p):
    return normalize(
        f"{random.choice(GOTO_VERBS)} {choose_det(make_source_obj(p))} {make_room(p)}"
    )


def object_nav_rel_attribute(p):
    return normalize(
        f"{random.choice(GOTO_VERBS)} the {make_rel_attribute(p)} {make_room(p)}"
    )


def object_nav_local_ref(p):
    return normalize(
        f"{random.choice(GOTO_VERBS)} {choose_det(make_source_obj(p))} {make_local_ref(p)}"
    )


def object_nav_affordance(p):
    return normalize(f"{random.choice(GOTO_VERBS)} {choose_det(make_affordance(p))}")


def object_nav_description(p):
    desc = normalize(p.get("description", p.get("uid", "object")))
    return normalize(f"{random.choice(GOTO_VERBS)} the {desc}")


def object_nav_multi(p):
    sources = p["synsets"]
    verb = random.choice(GOTO_VERBS)
    if len(sources) == 2:
        res = f"{verb} {choose_det(normalize(sources[0]))} and {choose_det(normalize(sources[1]))}"
    elif len(sources) >= 3:
        res = (
            f"{verb} {', '.join(choose_det(normalize(s)) for s in sources[:-1])},"
            f" and {choose_det(normalize(sources[-1]))}"
        )
    else:
        raise ValueError("object_nav_multi needs >= 2 synsets")
    return normalize(f"{res}, in that order")


def fetch_type(p):
    src = make_source_obj(p)
    return normalize(
        f"{random.choice(GOTO_VERBS)} {choose_det(src)} and "
        f"{random.choice(PICKUP_VERBS)} that {src}"
    )


def pickup_type(p):
    return normalize(f"{random.choice(PICKUP_VERBS)} {choose_det(make_source_obj(p))}")


def room_visit(p):
    return normalize(
        f"Go to all {p['num_rooms_in_house']} rooms in the house."
        f" Indicate when you have seen a new room and when you are done"
    )


def room_nav(p):
    return normalize(
        f"{random.choice(GOTO_VERBS)} {choose_det(normalize(p['room_types'][0]))}"
    )


def go_to_point(p):
    """reference task_spec_to_instruction.py:391-393."""
    return normalize(f"{random.choice(GOTO_POINT_VERBS)} point")


def go_near_point(p):
    """reference task_spec_to_instruction.py:396-398."""
    return normalize(f"{random.choice(GOTO_POINT_VERBS)} object")


REGISTERED_INSTRUCTION_TYPES = dict(
    PickupType=pickup_type,
    FetchType=fetch_type,
    EasyFetchType=fetch_type,
    RoomVisit=room_visit,
    ObjectNavType=object_nav_type,
    EasyObjectNavType=object_nav_type,
    ObjectNavRoom=object_nav_room,
    ObjectNavRelAttribute=object_nav_rel_attribute,
    ObjectNavAffordance=object_nav_affordance,
    ObjectNavLocalRef=object_nav_local_ref,
    ObjectNavDescription=object_nav_description,
    RoomNav=room_nav,
    ObjectNavMulti=object_nav_multi,
    # BPE variants share the base templates (reference l.223-226, 260-277)
    BPEObjectNavType=object_nav_type,
    BPEObjectNavMulti=object_nav_multi,
    GoToPoint=go_to_point,
    GoNearPoint=go_near_point,
    # learnability probes (tasks/probe.py): the spec's own NL string IS the
    # instruction — InstructionBandit's reward is defined by it ("turn
    # left"/"turn right"), ConstrainedBandit's is instruction-independent
    ConstrainedBandit=lambda p: p.get("natural_language_spec", "stay safe"),
    InstructionBandit=lambda p: p["natural_language_spec"],
)


def get_natural_language_spec(task_type: str, task_data: Dict[str, Any]) -> str:
    from safevla_tpu_torch.tasks.task_specs import map_task_type

    return REGISTERED_INSTRUCTION_TYPES[map_task_type(task_type)](task_data)
