"""Eval sample schemas + conversions (reference online_evaluation/
online_evaluation_types_and_utils.py and max_episode_configs.py).

Copy of `safevla_tpu/evaluation/types.py`; `load_benchmark_episodes` also
reads a file holding one JSON list of episodes.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, TypedDict

from safevla_tpu_torch.tasks.task_specs import map_task_spec, map_task_type
from safevla_tpu_torch.types import REGISTERED_TASK_PARAMS

MAX_EPISODE_LEN_PER_TASK = {
    "RoomVisit": 1000,
    "ObjectNavMulti": 1000,
    "FetchType": 600,
    "ObjectNavRelAttribute": 600,
    "ObjectNavLocalRef": 600,
    "ObjectNavDescription": 600,
    "ObjectNavRoom": 600,
    "RoomNav": 600,
    "ObjectNavType": 600,
    "ObjectNavAffordance": 600,
    "PickupType": 600,
    "EasyObjectNavType": 600,
    "EasyFetchType": 600,
}


class EvalSample(TypedDict, total=False):
    task_type: str
    house_index: int
    natural_language_spec: str
    agent_starting_position: List[float]
    agent_y_rotation: float
    expert_length: int
    synsets: List[str]
    synset_to_object_ids: Dict[str, List[str]]
    broad_synset_to_object_ids: Dict[str, List[str]]
    extras: Dict[str, Any]


class NormalizedEvalSample(TypedDict, total=False):
    task_type: str
    house_id: str
    sample_id: str
    sub_house_id: int
    needs_video: bool
    observations: Dict[str, Any]


def map_hard_easy_objectnavtype_to_objectnavtype(task_type: str) -> str:
    if task_type in ("HardObjectNavType", "EasyObjectNavType"):
        task_type = "ObjectNavType"
    return task_type


def eval_sample_to_normalized_eval_sample(
    task_type: str, sample: EvalSample, index: int
) -> NormalizedEvalSample:
    if "task_type" in sample:
        declared = map_task_type(sample["task_type"])
    assert task_type == declared, (
        f"--task-type {task_type!r} does not match benchmark sample type {declared!r}"
    )
    return NormalizedEvalSample(
        sample_id=f"task={task_type},house={sample['house_index']},sub_house_id={index}",
        house_id=str(sample["house_index"]).zfill(6),
        task_type=map_hard_easy_objectnavtype_to_objectnavtype(task_type),
        sub_house_id=index,
        needs_video=False,
        observations={
            "goal": sample["natural_language_spec"],
            "initial_agent_location": list(sample["agent_starting_position"])
            + [0, sample["agent_y_rotation"], 0],
            "templated_task_type": json.dumps(sample, default=str),
        },
    )


def normalized_eval_sample_to_task_spec(s: NormalizedEvalSample) -> Dict[str, Any]:
    info = json.loads(s["observations"]["templated_task_type"])
    loc = s["observations"]["initial_agent_location"]
    task_spec = {
        "task_type": s["task_type"],
        "house_index": int(s["house_id"]),
        "natural_language_spec": s["observations"]["goal"],
        "agent_starting_position": list(loc[:3]),
        "agent_y_rotation": float(loc[-2]),
        "eval_info": {
            "sample_id": s["sample_id"],
            "needs_video": s.get("needs_video", False),
            **info,
        },
    }
    task_spec = map_task_spec(task_spec)
    for key in REGISTERED_TASK_PARAMS.get(s["task_type"], []):
        if key not in info:
            raise KeyError(
                f"Key {key} required by {s['task_type']} missing from eval sample"
            )
        task_spec[key] = info[key]
    return task_spec


def load_benchmark_episodes(path: str) -> List[EvalSample]:
    """Load benchmark/*_val.jsonl.gz episode files: one episode per line, or
    one JSON list of episodes (gzipped when the name ends in .gz)."""
    import gzip

    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        text = f.read()
    if text.lstrip().startswith("["):
        return list(json.loads(text))
    return [json.loads(line) for line in text.splitlines() if line.strip()]
