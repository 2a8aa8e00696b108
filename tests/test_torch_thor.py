"""The port's AI2-THOR stack against the JAX package's, on the mock backend.

* `StretchController` of both packages, each over its own instance of
  `torch_thor_mock.MockTHOR`, receives the same script (every agent action,
  with the quick and the plain navigation actions; the arm against its
  limits and a stuck arm; the wrist against its bounds; pickup and drop-off;
  a reset with its navmesh injection and calibration; teleports; the
  visibility caches, paths, distances and room queries): the mocks' call
  logs, every returned event's metadata and truthiness, and both cropped
  cameras must be equal.
* `default_thor_env_args` gives the same arguments.
* `StretchState.difference` and the tolerance check agree with JAX's on
  random poses, wrist angles and held objects, exactly.
"""

import copy
import random

import numpy as np
import pytest

import torch_thor_mock as mock
from safevla_tpu.constants import ALL_STRETCH_ACTIONS as JAX_ACTIONS
from safevla_tpu.envs import stretch_state as jss
from safevla_tpu_torch.constants import ALL_STRETCH_ACTIONS
from safevla_tpu_torch.envs import stretch_state as pss


@pytest.fixture
def thor(monkeypatch):
    mock.install(mock.ModuleSetter(monkeypatch))
    from safevla_tpu.envs import thor_controller as jthor
    from safevla_tpu_torch.envs import thor_controller as pthor

    return jthor, pthor


def _script(house):
    """(op, argument) pairs: every action twice, the arm driven into its
    limits, a stuck arm, teleports inside and outside the house, queries."""
    ops = [("reset", house)]
    ops += [("act", a) for a in ALL_STRETCH_ACTIONS if a not in ("end", "sub_done")] * 2
    ops += [("act", "zp")] * 7 + [("act", "yp")] * 12 + [("act", "wm")] * 9 + [("act", "wp")] * 40
    ops += [("stuck", "ym"), ("act", "ym")]
    ops += [("teleport", ({"x": 2.0, "y": 0.9, "z": 2.0}, 45)), ("act", "m"), ("act", "m")]
    ops += [("teleport", ({"x": 20.0, "y": 0.9, "z": 2.0}, {"x": 0, "y": 180, "z": 0}))]
    ops += [("query", None), ("reset", house), ("act", "r"), ("query", None)]
    return ops


def _drive(module, ops, **kwargs):
    random.seed(7)
    np.random.seed(7)
    c = module.StretchController(**kwargs)
    out = []
    for op, arg in ops:
        if op == "reset":
            ev = c.reset(copy.deepcopy(arg))
        elif op == "act":
            ev = c.agent_step(arg)
        elif op == "stuck":  # an arm that does not move must report failure
            c.controller.step, real = (lambda *a, **k: c.controller.last_event), c.controller.step
            ev = c.agent_step(arg)
            c.controller.step = real
        elif op == "teleport":
            ev = c.teleport_agent(*arg)
        else:
            objs = [o["objectId"] for o in c.get_objects()]
            ev = None
            out.append((
                c.get_visible_objects("both", 3), c.get_visible_objects(maximum_distance=2),
                c.object_is_visible_in_camera(objs[0]), c.get_reachable_positions()[:5],
                c.get_closest_object_from_ids(objs[:3]), c.get_shortest_path_to_object(objs[1]),
                [c.dist_from_arm_sphere_center_to_obj(o) for o in objs],
                [c.dist_from_arm_sphere_center_to_obj_colliders_closest_to_point(o) for o in objs],
                [c.get_agent_alignment_to_object(o, use_arm_orientation=u) for o in objs for u in (False, True)],
                c.get_objects_room_id_and_type(objs[2]), c.get_room_id_from_location(c.get_current_agent_position()),
                c.get_all_objects_of_synset("mug.n.01"), c.get_arm_proprioception(), c.get_held_objects(),
                c.get_objects_in_hand_sphere(), c.get_current_agent_full_pose(),
                c.get_relative_stretch_current_arm_state(), c.get_top_down_path_view([c.get_current_agent_position()])[0],
            ))
        if ev is not None:
            out.append((copy.deepcopy(ev.metadata), bool(ev)))
        out.append((c.navigation_camera.copy(), c.manipulation_camera.copy()))
    c.stop()
    return c.controller.calls, out, (c.room_poly_map.keys(), c.room_type_dict)


def _assert_same(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    else:
        assert a == b and type(a) is type(b), (a, b)


@pytest.mark.parametrize("quick,mani", [(True, True), (False, True), (True, False)])
def test_stretch_controller_matches_jax(thor, quick, mani):
    jthor, pthor = thor
    assert JAX_ACTIONS == ALL_STRETCH_ACTIONS
    house = mock.make_house(3)
    kwargs = dict(use_quick_navi_action=quick, render_mani_camera=mani, width=396, height=224)
    want = _drive(jthor, _script(house), **kwargs)
    got = _drive(pthor, _script(house), **kwargs)
    _assert_same(got[0], want[0])
    _assert_same(got[1], want[1])
    assert list(got[2][0]) == list(want[2][0]) and got[2][1] == want[2][1]
    actions = [c["action"] for c in got[0]]
    # the reset's navmeshes (one per agent radius) and the calibration
    reset = next(c for c in got[0] if c["action"] == "__reset__")
    assert [m["agentRadius"] for m in reset["scene"]["metadata"]["navMeshes"]] == [0.5, 0.4, 0.3, 0.2]
    assert actions.count("RotateCameraMount") == 4 and actions.count("ChangeFOV") == 4
    assert ("MoveAheadQuick" in actions) == quick and ("MoveAgent" in actions) == (not quick)
    assert got[1][-1][0].shape == (224, 384, 3)


def test_stretch_controller_refuses_a_raw_teleport(thor):
    _, pthor = thor
    c = pthor.StretchController()
    with pytest.raises(NotImplementedError):
        c.step(action="Teleport", position={})
    with pytest.raises(NotImplementedError, match="Action not defined"):
        c.agent_step("end")


def test_default_thor_env_args_match_jax(thor):
    jthor, pthor = thor
    want, got = jthor.default_thor_env_args(), pthor.default_thor_env_args()
    assert got == want
    assert got["server_class"] is mock.FifoServer and (got["width"], got["height"]) == (396, 224)
    assert pthor.default_thor_env_args(width=128)["width"] == 128


def _random_state(module, rng):
    s = module.StretchState()
    s._base_position = {"x": rng.uniform(-3, 3), "y": 0.9, "z": rng.uniform(-3, 3), "theta": rng.uniform(0, 360)}
    s._wrist_pose = {"y": rng.uniform(0, 1), "z": rng.uniform(0, 0.5), "yaw": rng.uniform(-180, 360)}
    s._hand_position = {k: rng.uniform(-2, 2) for k in "xyz"}
    s._gripper_openness = rng.uniform(0, 50)
    s._held_oids = {(True, f"Obj|{i}") for i in rng.choice(4, rng.integers(0, 3), replace=False)}
    return s


def test_stretch_state_matches_jax():
    rng_j, rng_p = np.random.default_rng(2), np.random.default_rng(2)  # the same states on both sides
    rng = np.random.default_rng(3)
    tolerance = dict(
        diff_base={"x": 0.01, "z": 0.01, "theta": 1.5},
        diff_wrist={"y": 0.005, "z": 0.005, "yaw": 2},
        diff_hand={"x": 100, "y": 100, "z": 100},
        diff_gripper=100,
        diff_held_oids=set(),
    )
    jtol = jss.StretchState._create_difference_state(**copy.deepcopy(tolerance))
    ptol = pss.StretchState._create_difference_state(**copy.deepcopy(tolerance))
    verdicts = set()
    for i in range(200):
        ja, jb = _random_state(jss, rng_j), _random_state(jss, rng_j)
        pa, pb = _random_state(pss, rng_p), _random_state(pss, rng_p)
        if i % 4 == 0:  # small moves, around the tolerance
            jb._base_position = {k: v + (1e-3 * i % 0.03) for k, v in ja._base_position.items()}
            pb._base_position = {k: v + (1e-3 * i % 0.03) for k, v in pa._base_position.items()}
            jb._wrist_pose, pb._wrist_pose = dict(ja._wrist_pose), dict(pa._wrist_pose)
            jb._held_oids, pb._held_oids = set(ja._held_oids), set(pa._held_oids)
        jd, pd = jss.StretchState.difference(jb, ja), pss.StretchState.difference(pb, pa)
        for attr in ("base_position", "wrist_pose", "hand_position", "gripper_openness", "held_oids"):
            assert getattr(pd, attr) == getattr(jd, attr), attr
        got = pss.StretchState.state_change_within_tolerance(pd, ptol)
        assert got == jss.StretchState.state_change_within_tolerance(jd, jtol)
        verdicts.add(got[0])
        yaw0, yaw1 = rng.uniform(-400, 400, 2)
        assert pss.StretchState.signed_travel_distance_wrist(yaw0, yaw1) == (
            jss.StretchState.signed_travel_distance_wrist(yaw0, yaw1)
        )
        world, agent = ({k: rng.uniform(-5, 5) for k in "xyz"} for _ in range(2))
        yaw = rng.uniform(0, 360)
        assert pss.convert_world_to_agent_coordinate(world, agent, yaw) == jss.convert_world_to_agent_coordinate(
            world, agent, yaw)
        assert pss.convert_agent_to_world_coordinate(world, agent, yaw) == jss.convert_agent_to_world_coordinate(
            world, agent, yaw)
    assert verdicts == {True, False}
