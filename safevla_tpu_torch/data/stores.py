"""Host-side data stores: houses, task specs (jsonl.gz and hdf5).

The port's copy of `safevla_tpu/data/stores.py`. Semantics match reference
utils/data_utils.py: lazily-parsed jsonl.gz lines with a per-index cache,
and hdf5 task-spec stores sharded round-robin across loader processes.
`h5py` is imported only where an hdf5 file is read.
"""

from __future__ import annotations

import gzip
import json
import os
import warnings
from collections import defaultdict
from typing import Any, Dict, List, Optional, Sequence, Union

JsonType = Union[str, bytes]


def read_jsonlgz(path: str, max_lines: Optional[int] = None) -> List[bytes]:
    with gzip.open(path, "r") as f:
        lines: List[bytes] = []
        for line in f:
            lines.append(line)
            if max_lines is not None and len(lines) >= max_lines:
                break
    return lines


class LazyJsonDataset:
    """A list of json documents, parsed on first access and cached."""

    def __init__(self, data: List[JsonType]) -> None:
        self.data = data
        self.cached_data: Dict[int, Any] = {}

    def __getitem__(self, index: int) -> Any:
        if index not in self.cached_data:
            self.cached_data[index] = json.loads(self.data[index])
        return self.cached_data[index]

    def __len__(self) -> int:
        return len(self.data)

    def __iter__(self):
        for i in range(len(self.data)):
            yield self[i]

    def __repr__(self):
        return (
            f"{type(self).__name__}(num_samples={len(self)},"
            f" cached_samples={len(self.cached_data)})"
        )

    def select(self, indices: Sequence[int]) -> "LazyJsonDataset":
        return type(self)(data=[self.data[i] for i in indices])

    @classmethod
    def from_jsonlgz(cls, path: str, max_lines: Optional[int] = None):
        return cls(data=read_jsonlgz(path=path, max_lines=max_lines))

    @classmethod
    def from_dir(cls, directory: str, subset: str, max_lines: Optional[int] = None):
        return cls.from_jsonlgz(
            path=os.path.join(directory, f"{subset}.jsonl.gz"), max_lines=max_lines
        )


class LazyJsonHouses(LazyJsonDataset):
    pass


class LazyJsonTaskSpecs(LazyJsonDataset):
    pass


class DatasetDict(dict):
    def __getattr__(self, key):
        try:
            return self[key]
        except KeyError:
            raise AttributeError(key)


def load_dataset_from_path(
    path_to_splits: Optional[str] = None,
    split_to_path: Optional[Dict[str, str]] = None,
    max_items_per_split: Optional[Union[int, Dict[str, int]]] = None,
) -> DatasetDict:
    assert (path_to_splits is None) != (split_to_path is None)
    if not isinstance(max_items_per_split, dict):
        scalar_max = max_items_per_split
        max_items_per_split = defaultdict(lambda: scalar_max)
    else:
        max_items_per_split = defaultdict(lambda: None, max_items_per_split)

    if path_to_splits is not None:
        if not os.path.exists(path_to_splits):
            raise FileNotFoundError(path_to_splits)
        split_to_path = {
            s: os.path.join(path_to_splits, s) for s in ("train", "val", "test")
        }

    out = {}
    for split, path in split_to_path.items():
        if not os.path.exists(path):
            warnings.warn(f"Split '{split}' path does not exist: {path}; skipped")
            continue
        if path.endswith(".jsonl.gz"):
            out[split] = LazyJsonDataset.from_jsonlgz(path, max_items_per_split[split])
        elif os.path.isdir(path):
            files = [f for f in os.listdir(path) if f.endswith(".jsonl.gz")]
            if files:
                out[split] = LazyJsonDataset.from_jsonlgz(
                    os.path.join(path, files[0]), max_items_per_split[split]
                )
            else:
                warnings.warn(f"{path} contains no .jsonl.gz files")
        else:
            warnings.warn(f"Unsupported path type: {path}")
    if not out:
        raise ValueError("No valid splits found")
    return DatasetDict(**out)


def load_hdf5_sensor(path: str) -> List[Dict]:
    """Parse one hdf5_sensors.hdf5 file into task-spec dicts
    (reference data_utils.py:215-235)."""
    if not os.path.isfile(path):
        return []
    import h5py

    from safevla_tpu_torch.tasks.task_specs import map_task_type
    from safevla_tpu_torch.utils.string_codec import convert_byte_to_string

    data = []
    with h5py.File(path, "r") as d:
        for k in d.keys():
            spec = json.loads(convert_byte_to_string(d[k]["templated_task_spec"][0, :]))
            spec["task_type"] = map_task_type(spec["task_type"])
            spec["house_index"] = int(d[k]["house_index"][0])
            loc = d[k]["last_agent_location"][0]
            spec["agent_starting_position"] = [loc[0], loc[1], loc[2]]
            spec["agent_y_rotation"] = loc[4]
            if "natural_language_spec" not in spec:
                from safevla_tpu_torch.utils.instructions import get_natural_language_spec

                spec["natural_language_spec"] = get_natural_language_spec(
                    spec["task_type"], spec
                )
            data.append(spec)
    return data


class Hdf5TaskSpecs:
    """{dataset_dir}/{subset}/*/hdf5_sensors.hdf5, round-robin sharded by
    (proc_id, total_procs)."""

    def __init__(
        self,
        subset_dir: str,
        data: Optional[List[Dict]] = None,
        proc_id: Optional[int] = None,
        total_procs: Optional[int] = None,
        max_house_id: Optional[int] = None,
        max_task_specs: Optional[int] = None,
    ) -> None:
        self.subset_dir = subset_dir
        self.proc_id = proc_id or 0
        self.total_procs = total_procs or 1
        self.max_house_id = max_house_id
        if data is None:
            subdirs = sorted(os.listdir(subset_dir))
            if max_house_id is not None:
                subdirs = [s for s in subdirs if int(s) < max_house_id]
            paths = [
                os.path.join(subset_dir, s, "hdf5_sensors.hdf5")
                for i, s in enumerate(subdirs)
                if i % self.total_procs == self.proc_id
            ]
            data = []
            for p in paths:
                data.extend(load_hdf5_sensor(p))
        self.data = data[: max_task_specs if max_task_specs is not None else len(data)]

    def __getitem__(self, index: int):
        return self.data[index]

    def __len__(self):
        return len(self.data)

    def __iter__(self):
        return iter(self.data)

    def __repr__(self):
        return (
            f"Hdf5TaskSpecs(num_samples={len(self)},proc_id={self.proc_id},"
            f"total_procs={self.total_procs})"
        )

    def select(self, indices: Sequence[int]) -> "Hdf5TaskSpecs":
        return Hdf5TaskSpecs(
            subset_dir=self.subset_dir,
            data=[self.data[i] for i in indices],
            proc_id=self.proc_id,
            total_procs=self.total_procs,
        )

    @staticmethod
    def from_dataset_dir(
        dataset_dir: str,
        subset: str,
        proc_id: Optional[int] = None,
        total_procs: Optional[int] = None,
        max_house_id: Optional[int] = None,
        max_task_specs: Optional[int] = None,
    ) -> "Hdf5TaskSpecs":
        return Hdf5TaskSpecs(
            subset_dir=os.path.join(dataset_dir, subset),
            proc_id=proc_id,
            total_procs=total_procs,
            max_house_id=max_house_id,
            max_task_specs=max_task_specs,
        )
