"""The port's CHORES data path against the JAX package's, exactly.

One miniature CHORES directory (2 houses x 2 episodes of 6-11 steps, hdf5
sensors and `.npy` frames, as tests/test_offline.py builds it, plus the
`house_index` that `load_hdf5_sensor` reads) feeds both packages'
`ChoresDataset`; with the global `random` and `np.random` seeded the same
before each side reads, every window (plain slicing, action-redundancy
subsampling, last-steps sampling) and its collated batch are equal, array
for array. Then the stores (`load_hdf5_sensor`, `Hdf5TaskSpecs`,
`LazyJsonDataset.from_jsonlgz`, `load_dataset_from_path`) and the
instruction templates (`get_natural_language_spec`, seeded).
"""

import gzip
import json
import os
import random

import numpy as np
import pytest

from safevla_tpu.constants import ALL_STRETCH_ACTIONS
from safevla_tpu.data import chores as jchores
from safevla_tpu.data import stores as jstores
from safevla_tpu.utils import instructions as jinstr
from safevla_tpu.utils.string_codec import convert_string_to_byte
from safevla_tpu_torch.data import chores as pchores
from safevla_tpu_torch.data import stores as pstores
from safevla_tpu_torch.utils import instructions as pinstr

H, W = 28, 42


def write_chores_dir(root, houses=("000001", "000002"), episodes=2, seed=0, lengths=(6, 12)):
    """A miniature CHORES-format dataset under `root` (a pathlib.Path):
    `houses` x `episodes`, each of a random length in [lengths), with a
    random action sequence, an ObjectNavType spec, zero agent locations and
    object-in-hand flags, and random uint8 frames saved as `.npy` stand-ins
    for the mp4s. Returns str(root)."""
    import h5py

    house_map = {}
    rng = np.random.default_rng(seed)
    for hi, house in enumerate(houses):
        house_dir = root / "train" / house
        os.makedirs(house_dir)
        sub_ids = []
        with h5py.File(house_dir / "hdf5_sensors.hdf5", "w") as f:
            for ep in range(episodes):
                sub_id = str(ep)
                sub_ids.append(sub_id)
                n = int(rng.integers(*lengths))
                grp = f.create_group(sub_id)
                actions = [""] + [
                    ALL_STRETCH_ACTIONS[int(rng.integers(len(ALL_STRETCH_ACTIONS)))] for _ in range(n - 1)
                ]
                grp.create_dataset("last_action_str", data=np.stack([convert_string_to_byte(a, 20) for a in actions]))
                spec = {
                    "task_type": "ObjectNavType",
                    "synsets": ["mug.n.01"],
                    "synset_to_object_ids": {"mug.n.01": ["Mug|1"]},
                    "broad_synset_to_object_ids": {"mug.n.01": ["Mug|1"]},
                    "extras": {},
                }
                s = json.dumps(spec)
                grp.create_dataset("templated_task_spec", data=convert_string_to_byte(s, 2 * len(s)).reshape(1, -1))
                grp.create_dataset("last_agent_location", data=np.zeros((1, 6), np.float64))
                grp.create_dataset("house_index", data=np.full((1,), hi, np.int64))
                grp.create_dataset("an_object_is_in_hand", data=rng.integers(0, 2, (n, 1)))
                frames = rng.integers(0, 255, (n, H, W, 3), dtype=np.uint8)
                np.save(house_dir / f"raw_navigation_camera__{sub_id}.npy", frames)
                np.save(house_dir / f"raw_manipulation_camera__{sub_id}.npy", frames[::-1].copy())
        house_map[house] = sub_ids
    with open(root / "house_id_to_sub_house_id_train.json", "w") as f:
        json.dump(house_map, f)
    return str(root)


@pytest.fixture(scope="module")
def chores_dir(tmp_path_factory):
    return write_chores_dir(tmp_path_factory.mktemp("chores"), houses=("000001", "000002", "000003"))


def _seeded(seed, fn):
    random.seed(seed)
    np.random.seed(seed)
    return fn()


def _assert_equal_items(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize(
    "window,redundancy,last_steps",
    [(5, False, 0.0), (5, True, 0.0), (5, False, 0.5), (4, True, 0.5), (50, False, 0.0)],
)
def test_windows_and_collate_match_jax(chores_dir, window, redundancy, last_steps):
    """Every sample's window, read twice per epoch from the same seeds, and
    the collated batches, equal to JAX's."""
    kw = dict(sliding_window=window, reduce_action_redundancy=redundancy)
    jds = jchores.ChoresDataset(chores_dir, "train", **kw)
    pds = pchores.ChoresDataset(chores_dir, "train", **kw)
    assert [s["sample_id"] for s in jds.samples] == [s["sample_id"] for s in pds.samples]
    assert (jds.start_token, jds.pad_token) == (pds.start_token, pds.pad_token)
    jds.set_prob_sample_last_steps(last_steps)
    pds.set_prob_sample_last_steps(last_steps)
    for seed in (0, 1):
        want = _seeded(seed, lambda: [jds[i] for i in range(len(jds))])
        got = _seeded(seed, lambda: [pds[i] for i in range(len(pds))])
        for a, b in zip(want, got):
            _assert_equal_items(a, b)
            assert len(b["actions"]) == min(window, len(b["actions"]))
        jb = jchores.collate_window_batch(want, window, jds.pad_token)
        pb = pchores.collate_window_batch(got, window, pds.pad_token)
        _assert_equal_items(jb, pb)


def test_multitask_dataset_interleaves_like_jax(chores_dir):
    jm = jchores.ChoresMultitaskDataset([jchores.ChoresDataset(chores_dir, "train", sliding_window=5)] * 2)
    pm = pchores.ChoresMultitaskDataset([pchores.ChoresDataset(chores_dir, "train", sliding_window=5)] * 2)
    assert len(jm) == len(pm) == 12 and jm.index == pm.index
    jm.set_prob_sample_last_steps(1.0)
    pm.set_prob_sample_last_steps(1.0)
    _assert_equal_items(_seeded(3, lambda: jm[7]), _seeded(3, lambda: pm[7]))


def test_hdf5_task_specs_match_jax(chores_dir):
    """load_hdf5_sensor over one house, and Hdf5TaskSpecs over the subset
    sharded across two processes, exactly as JAX reads them."""
    path = os.path.join(chores_dir, "train", "000002", "hdf5_sensors.hdf5")
    want = _seeded(5, lambda: jstores.load_hdf5_sensor(path))
    got = _seeded(5, lambda: pstores.load_hdf5_sensor(path))
    assert got == want and len(got) == 2 and got[0]["house_index"] == 1
    assert pstores.load_hdf5_sensor(path + ".missing") == []
    for proc in (0, 1):
        j = _seeded(6, lambda: jstores.Hdf5TaskSpecs.from_dataset_dir(chores_dir, "train", proc, 2))
        p = _seeded(6, lambda: pstores.Hdf5TaskSpecs.from_dataset_dir(chores_dir, "train", proc, 2))
        assert list(p) == list(j) and len(p) == (4 if proc == 0 else 2)
        assert list(p.select([0])) == [j[0]]


def test_lazy_json_stores_match_jax(tmp_path):
    docs = [{"house": i, "rooms": list(range(i))} for i in range(5)]
    os.makedirs(tmp_path / "train")
    path = tmp_path / "train" / "houses.jsonl.gz"
    with gzip.open(path, "wt") as f:
        f.writelines(json.dumps(d) + "\n" for d in docs)
    want = jstores.LazyJsonDataset.from_jsonlgz(str(path), max_lines=4)
    got = pstores.LazyJsonDataset.from_jsonlgz(str(path), max_lines=4)
    assert len(got) == len(want) == 4 and list(got) == list(want) == docs[:4]
    assert got.select([2, 0])[1] == docs[0]
    splits = pstores.load_dataset_from_path(split_to_path={"train": str(tmp_path / "train")})
    assert list(splits.train) == list(jstores.load_dataset_from_path(split_to_path={"train": str(tmp_path / "train")}).train)
    assert pstores.read_jsonlgz(str(path)) == jstores.read_jsonlgz(str(path))


SPECS = [
    ("ObjectNavType", {"synsets": ["coffee_mug.n.01"]}),
    ("ObjectNavRoom", {"synsets": ["apple.n.01"], "room_type": "kitchen"}),
    ("ObjectNavRelAttribute", {"synsets": ["bed.n.01"], "rel_attribute": ["closest", "door.n.01"], "room_type": "bedroom"}),
    ("ObjectNavLocalRef", {"synsets": ["mug.n.01"], "reference_type": "near", "reference_synsets": ["table.n.02", "chair.n.01"]}),
    ("ObjectNavAffordance", {"synsets": ["knife.n.01"], "affordance": "cutting"}),
    ("FetchType", {"synsets": ["apple.n.01"]}),
    ("PickupType", {"synsets": ["egg.n.02"]}),
    ("RoomVisit", {"num_rooms_in_house": 4}),
    ("RoomNav", {"room_types": ["living_room"]}),
    ("ObjectNavMulti", {"synsets": ["mug.n.01", "bowl.n.01", "apple.n.01"]}),
]


@pytest.mark.parametrize("task_type,spec", SPECS)
def test_natural_language_spec_matches_jax(task_type, spec):
    for seed in range(3):
        want = _seeded(seed, lambda: jinstr.get_natural_language_spec(task_type, spec))
        assert _seeded(seed, lambda: pinstr.get_natural_language_spec(task_type, spec)) == want
