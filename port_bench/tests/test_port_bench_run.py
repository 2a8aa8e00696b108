"""Whole runs of each cell at tiny widths on the CPU, past the look for a
card: a sound program comes out correct; a program broken underneath the
timed path comes out not correct, once for each fault a training cell can
have (a step that returns its state unchanged; half of the batch left out,
the mean taken over the rest). On the CPU the command itself fails for want
of a card, and no run loads JAX or the JAX package."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from port_bench import harness
from port_bench.tests import tiny

CELLS = [c["name"] for c in harness.benchmark()["workloads"]]
SEED = 4_294_967_311  # past 32 bits, as the driver's seeds are


def run(cell, patch=None, trace=False):
    result, lines = harness.run_cell(tiny.spec(cell), SEED, 0.5, trace, device="cpu", patch=patch)
    assert [ln.split()[1] for ln in lines if ln.startswith("check ")] == list(result["checks"])
    assert lines[-len(result["checks"]):] == [ln for ln in lines if ln.startswith("check ")]
    assert list(result)[-1] == "checks"
    return result


def unchanged(driver):
    """The program's step leaves its tower weights where they were."""
    if driver.tr["driver"] == "update":
        from safevla_tpu_torch.algo.learner import Learner as Step

        name = "update"
    else:
        from safevla_tpu_torch.training.offline import OfflineTrainer as Step

        name = "_bc_step"
    real = getattr(Step, name)

    def step(self, state, *args):
        saved = [p.detach().clone() for p in state.tower_params.values()]
        out = real(self, state, *args)
        with torch.no_grad():
            for p, s in zip(state.tower_params.values(), saved):
                p.copy_(s)
        return out

    driver._patch = (Step, name, step)


def half_batch(driver):
    """The program's step sees the first half of the batch's rows."""
    if driver.tr["driver"] == "update":
        from safevla_tpu_torch.algo.learner import Learner as Step

        name = "update"

        def cut(batch):
            b = batch["rewards"].shape[0]
            return {k: v[: b // 2] for k, v in batch.items()}
    else:
        from safevla_tpu_torch.training.offline import OfflineTrainer as Step

        name = "_bc_step"

        def cut(batch):
            b = batch["actions"].shape[0]
            return {k: v[: b // 2] for k, v in batch.items()}

    real = getattr(Step, name)

    def step(self, state, batch, *args):
        return real(self, state, cut(batch), *args)

    driver._patch = (Step, name, step)


@pytest.fixture
def broken(monkeypatch):
    def apply(fault):
        def patch(driver):
            fault(driver)
            monkeypatch.setattr(*driver._patch)

        return patch

    return apply


@pytest.mark.parametrize("cell", CELLS)
def test_sound_program_is_correct(cell):
    result = run(cell)
    assert result["correct"] and result["failed"] == 0 and result["attempted"] >= 1
    e2e = {m["name"] for m in harness.cell_metrics(harness.benchmark(), cell, False)}
    assert set(result["metrics"]) == e2e


@pytest.mark.parametrize("fault", [unchanged, half_batch], ids=["state_unchanged", "half_batch"])
@pytest.mark.parametrize("cell", CELLS)
def test_broken_program_is_not_correct(cell, fault, broken):
    assert not run(cell, patch=broken(fault))["correct"]


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reports_per_layer_metrics(cell):
    result = run(cell, trace=True)
    assert {"busy_s", "window_s"} <= set(result["device"]) and set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    names = {m["name"] for m in harness.cell_metrics(harness.benchmark(), cell, True)}
    assert set(result["metrics"]) <= names and result["metrics"]


def test_command_fails_without_a_card():
    proc = subprocess.run(
        [sys.executable, "port_bench/run.py", "--workload", CELLS[0], "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0 and proc.stdout.strip() == ""


@pytest.mark.parametrize("cell", CELLS)
def test_a_run_loads_no_jax(cell):
    code = (
        "import sys, json; sys.path.insert(0, '.');"
        "from port_bench import harness; from port_bench.tests import tiny;"
        f"harness.run_cell(tiny.spec({cell!r}), 7, 0.2, False, device='cpu');"
        "print(json.dumps(harness.forbidden_modules()))"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


def test_the_reference_loads_nothing_of_the_program():
    code = (
        "import sys; sys.path.insert(0, '.');"
        "import port_bench.reference.bc, port_bench.reference.learner, port_bench.reference.flops;"
        "print(sorted({m.split('.')[0] for m in sys.modules} & {'safevla_tpu_torch', 'safevla_tpu', 'jax'}))"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True, text=True, timeout=300)
    assert proc.stdout.strip().splitlines()[-1] == "[]", proc.stderr[-2000:]
