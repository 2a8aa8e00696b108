"""CHORES episode dataset: per-house hdf5 sensors + per-episode camera videos.

The port's copy of `safevla_tpu/data/chores.py` (counterpart of reference
training/offline/chores_dataset.py): sample discovery from
house_id_to_sub_house_id_{subset}.json, hdf5 sensor decode, mp4 frame
loading, sliding-window (default 50) slicing with optional
last-steps-biased sampling, and action-redundancy subsampling. The windows
draw from the global `random` and `np.random` exactly as the JAX package's
do, so the same seeds give the same windows.

Output protocol: numpy dicts with fixed-width windows, actions encoded as
ints with start token = num_actions and loss-ignore label -1 on padding,
ready for the BC step (training/offline.py). Video frames load from a
sibling .npy file with the same stem (the format this framework writes),
else via torchvision.io when available, else imageio.

The instruction of a window comes from `utils/instructions.py`, imported at
the top: the fallback to the spec's own `natural_language_spec` field
covers a spec that the templates cannot render, never a missing module.
"""

from __future__ import annotations

import json
import os
import random
from typing import Any, Dict, List, Optional

import numpy as np

from safevla_tpu_torch.constants import ALL_STRETCH_ACTIONS
from safevla_tpu_torch.utils.instructions import get_natural_language_spec
from safevla_tpu_torch.utils.string_codec import convert_byte_to_string


def load_video_frames(path: str) -> np.ndarray:
    """(T, H, W, 3) uint8 frames from mp4 (torchvision/imageio) or .npy."""
    npy = os.path.splitext(path)[0] + ".npy"
    if os.path.exists(npy):
        return np.load(npy)
    try:
        from torchvision.io import read_video

        frames, _, _ = read_video(path, pts_unit="sec", output_format="THWC")
        return frames.numpy()
    except Exception:
        pass
    try:
        import imageio.v3 as iio

        return np.stack(list(iio.imiter(path)))
    except Exception as e:
        raise RuntimeError(f"Cannot load video {path}: {e}")


class ChoresDataReader:
    """Sample discovery + hdf5 sensor decode (reference chores_dataset.py:24-140)."""

    def __init__(
        self,
        data_dir: str,
        subset: str,
        proc_idx: int = 0,
        num_procs: int = 1,
        max_samples: Optional[int] = None,
        seed: int = 123,
    ):
        self.data_dir = data_dir
        self.subset = subset
        self.proc_idx = proc_idx
        self.num_procs = num_procs
        self.max_samples = max_samples
        self.seed = seed
        self.house_map_json = os.path.join(
            data_dir, f"house_id_to_sub_house_id_{subset}.json"
        )

    def load_samples_for_proc_idx(self, proc_idx: int) -> List[Dict[str, Any]]:
        with open(self.house_map_json, "r") as f:
            house_map = json.load(f)
        house_ids = sorted(house_map.keys())
        assert house_ids, f"{self.data_dir}/{self.subset} has no houses"
        rng = random.Random(self.seed)
        rng.shuffle(house_ids)
        house_ids = [h for i, h in enumerate(house_ids) if i % self.num_procs == proc_idx]
        samples = []
        for house_id in house_ids:
            house_dir = os.path.join(self.data_dir, self.subset, house_id)
            for sub_house_id in house_map[house_id]:
                nav = os.path.join(
                    house_dir, f"raw_navigation_camera__{sub_house_id}.mp4"
                )
                samples.append(
                    dict(
                        sample_id=f"house={house_id},sub_house_id={sub_house_id}",
                        house_id=house_id,
                        sub_house_id=sub_house_id,
                        raw_navigation_camera=nav,
                        raw_manipulation_camera=nav.replace("navigation", "manipulation"),
                        sensors_path=os.path.join(house_dir, "hdf5_sensors.hdf5"),
                    )
                )
        rng = random.Random(self.seed)
        rng.shuffle(samples)
        return samples[: self.max_samples]

    def partial_load_samples(self) -> List[Dict[str, Any]]:
        return self.load_samples_for_proc_idx(self.proc_idx)

    def read_sensors(
        self,
        sensors_path: str,
        sub_house_id: str,
        additional_sensor_keys: Optional[List[str]] = None,
    ) -> Dict[str, Any]:
        import h5py

        keys = ["last_action_str", "initial_agent_location", "templated_task_spec"] + (
            additional_sensor_keys or []
        )
        sensors: Dict[str, Any] = {}
        with h5py.File(sensors_path, "r") as f:
            grp = f[sub_house_id]
            for k in keys:
                if k == "initial_agent_location":
                    sensors[k] = grp["last_agent_location"][0]
                elif k == "last_action_str":
                    sensors[k] = [
                        convert_byte_to_string(np.asarray(row), None) for row in grp[k]
                    ]
                elif k == "templated_task_spec":
                    sensors[k] = convert_byte_to_string(np.asarray(grp[k][0]), None)
                elif k == "an_object_is_in_hand":
                    if k in grp:
                        sensors[k] = grp[k][:, 0]
                    else:
                        sensors[k] = np.zeros(len(sensors["last_action_str"]))
                elif k in grp:
                    sensors[k] = grp[k][:]
        return sensors


class ChoresDataset:
    """Episode store with window slicing (reference chores_dataset.py:236-448)."""

    def __init__(
        self,
        data_dir: str,
        subset: str = "train",
        sliding_window: int = 50,
        max_samples: Optional[int] = None,
        proc_idx: int = 0,
        num_procs: int = 1,
        reduce_action_redundancy: bool = False,
        input_sensors: Optional[List[str]] = None,
        seed: int = 123,
    ):
        self.reader = ChoresDataReader(
            data_dir, subset, proc_idx, num_procs, max_samples, seed
        )
        self.samples = self.reader.partial_load_samples()
        self.sliding_window = sliding_window
        self.subset = subset
        self.reduce_action_redundancy = reduce_action_redundancy
        assert not reduce_action_redundancy or subset == "train"
        self.input_sensors = input_sensors or [
            "raw_navigation_camera",
            "raw_manipulation_camera",
            "last_actions",
            "an_object_is_in_hand",
        ]
        self.prob_sample_last_steps = 0.0
        self.action_to_idx = {a: i for i, a in enumerate(ALL_STRETCH_ACTIONS)}
        self.start_token = len(ALL_STRETCH_ACTIONS)  # "" start-of-episode token
        self.pad_token = len(ALL_STRETCH_ACTIONS) + 1

    def __len__(self) -> int:
        return len(self.samples)

    def set_prob_sample_last_steps(self, prob: float):
        """Curriculum knob (reference train_pl.py:209-228)."""
        self.prob_sample_last_steps = prob

    # ------------------------------------------------------------------
    def select_window_slice(
        self, n: int, start_idx: Optional[int] = None, sliding_window: Optional[int] = None
    ):
        w = sliding_window or self.sliding_window
        if w is None or n <= w:
            return slice(0, n)
        if start_idx is None:
            if random.random() < self.prob_sample_last_steps:
                start_idx = n - w
            else:
                start_idx = random.randint(0, n - w)
        return slice(start_idx, start_idx + w)

    def subsample_time_inds_to_reduce_action_redundancy(
        self,
        actions: np.ndarray,
        subsample_prob: float = 3.0 / 4,
        action_subsample_factor: float = 1.0 / 3,
    ):
        """Drop repeated consecutive actions with probability, keeping at least
        a full window (reference chores_dataset.py:295-348)."""
        w = self.sliding_window
        if w is None or len(actions) <= w:
            return np.arange(len(actions))
        if random.random() > subsample_prob:
            sl = self.select_window_slice(len(actions))
            return np.arange(len(actions))[sl]
        runs: List[List[int]] = []
        last = None
        for t, a in enumerate(actions):
            if a != last:
                runs.append([])
                last = a
            runs[-1].append(t)
        candidates = sum((r[1:] for r in runs), [])
        random.shuffle(candidates)
        num_remove = int(np.random.binomial(len(candidates), 1 - action_subsample_factor))
        num_remove = min(num_remove, len(actions) - w)
        removed = set(candidates[:num_remove])
        kept = np.array([t for t in range(len(actions)) if t not in removed])
        return kept[self.select_window_slice(len(kept))]

    # ------------------------------------------------------------------
    def __getitem__(self, i: int) -> Dict[str, Any]:
        sample = self.samples[i]
        sensors = self.reader.read_sensors(
            sample["sensors_path"],
            sample["sub_house_id"],
            additional_sensor_keys=[
                k
                for k in self.input_sensors
                if k not in ("raw_navigation_camera", "raw_manipulation_camera", "last_actions")
            ],
        )
        action_strs = sensors["last_action_str"]
        # last_action_str[t] is the action BEFORE step t ("" at episode start);
        # the BC target at t is the NEXT action = last_action_str[t + 1],
        # with the final step's target coming from the episode end
        n = len(action_strs)
        last_actions = np.array(
            [
                self.start_token if a == "" else self.action_to_idx.get(a, self.start_token)
                for a in action_strs
            ],
            np.int32,
        )
        targets = np.concatenate([last_actions[1:], [self.action_to_idx["end"]]])

        if self.reduce_action_redundancy:
            time_inds = self.subsample_time_inds_to_reduce_action_redundancy(targets)
        else:
            sl = self.select_window_slice(n)
            time_inds = np.arange(n)[sl]

        out: Dict[str, Any] = {
            "sample_id": sample["sample_id"],
            "time_ids": time_inds.astype(np.int32),
            "last_actions": last_actions[time_inds],
            "actions": targets[time_inds].astype(np.int32),
            "templated_task_spec": sensors["templated_task_spec"],
        }
        task = json.loads(sensors["templated_task_spec"])
        out["task_type"] = task.get("task_type", "ObjectNavType")
        try:
            out["natural_language_spec"] = get_natural_language_spec(
                out["task_type"], task
            )
        except Exception:
            out["natural_language_spec"] = task.get("natural_language_spec", "")

        if "raw_navigation_camera" in self.input_sensors:
            frames = load_video_frames(sample["raw_navigation_camera"])
            assert len(frames) >= n, (
                f"{sample['sample_id']}: {len(frames)} frames < {n} actions"
            )
            out["raw_navigation_camera"] = frames[time_inds]
        if "raw_manipulation_camera" in self.input_sensors:
            frames = load_video_frames(sample["raw_manipulation_camera"])
            out["raw_manipulation_camera"] = frames[time_inds]
        if "an_object_is_in_hand" in self.input_sensors:
            oih = np.asarray(sensors.get("an_object_is_in_hand", np.zeros(n)))
            out["an_object_is_in_hand"] = oih[time_inds].astype(np.int32)
        return out


class ChoresMultitaskDataset:
    """Interleave several ChoresDatasets (reference chores_dataset.py:451+)."""

    def __init__(self, datasets: List[ChoresDataset]):
        self.datasets = datasets
        self.index: List = []
        for d_i, d in enumerate(datasets):
            self.index.extend((d_i, j) for j in range(len(d)))

    def __len__(self):
        return len(self.index)

    def __getitem__(self, i):
        d_i, j = self.index[i]
        return self.datasets[d_i][j]

    def set_prob_sample_last_steps(self, prob: float):
        for d in self.datasets:
            d.set_prob_sample_last_steps(prob)


def collate_window_batch(
    samples: List[Dict[str, Any]], window: int, pad_token: int
) -> Dict[str, np.ndarray]:
    """Pad variable-length windows to (B, window); label padding with -1."""
    B = len(samples)
    ref = samples[0]
    h, w, _ = ref["raw_navigation_camera"].shape[1:]
    batch = {
        "rgb_nav": np.zeros((B, window, h, w, 3), np.uint8),
        "rgb_manip": np.zeros((B, window, h, w, 3), np.uint8),
        "last_actions": np.full((B, window), pad_token, np.int32),
        "actions": np.full((B, window), -1, np.int32),
        "time_ids": np.zeros((B, window), np.int32),
        "an_object_is_in_hand": np.zeros((B, window), np.int32),
        "padding_mask": np.ones((B, window), bool),
        "instructions": [s["natural_language_spec"] for s in samples],
    }
    for b, s in enumerate(samples):
        t = min(len(s["actions"]), window)
        batch["rgb_nav"][b, :t] = s["raw_navigation_camera"][:t]
        if "raw_manipulation_camera" in s:
            batch["rgb_manip"][b, :t] = s["raw_manipulation_camera"][:t]
        batch["last_actions"][b, :t] = s["last_actions"][:t]
        batch["actions"][b, :t] = s["actions"][:t]
        batch["time_ids"][b, :t] = s["time_ids"][:t]
        if "an_object_is_in_hand" in s:
            batch["an_object_is_in_hand"][b, :t] = s["an_object_is_in_hand"][:t]
        batch["padding_mask"][b, :t] = False
    return batch
