"""BENCHMARK.json and the files it names: every cell's configuration,
traffic, driver, limits and metrics exist and agree with each other and
with the program; the benchmark's frozen work counts agree with the
program's analytic count less its recomputed term."""

from __future__ import annotations

import ast
import dataclasses
import json
import re

import pytest
import torch

from port_bench import harness
from port_bench.reference import flops as FL
from port_bench.reference import params as P

BENCH = harness.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CELLS = [c["name"] for c in BENCH["workloads"]]


def test_top_level_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["port_bench"] and BENCH["command"] == ["python3", "port_bench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in BENCH[k]]
    assert all(NAME.match(n) for n in names) and len(set(names)) == len(names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_exist(cell):
    spec = harness.Spec(cell)
    assert (harness.BENCH_DIR / "drivers" / f"{spec.traffic['driver']}.py").exists()
    steps = spec.traffic["compared_steps"]
    assert spec.workload["limits"] and set(spec.workload["limits"]) <= {f"loss.{i + 1}" for i in range(steps)} | {"grad", "change"}
    assert spec.workload["config"] == spec.cell["config"] and spec.workload["traffic"] == spec.cell["traffic"]
    for m in harness.cell_metrics(BENCH, cell, False) + harness.cell_metrics(BENCH, cell, True):
        assert harness.metric_file(m["name"]).exists(), m["name"]


def test_a_metric_split_by_cell_falls_back_on_its_base_reader():
    assert harness.metric_file("mfu.update").name == "mfu.py"
    assert harness.metric_file("attn_fwd_roofline.bc").name == "attn_fwd_roofline.bc.py"
    assert not harness.metric_file("no_such_metric.bc").exists()


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric(cell):
    e2e = {m["name"] for m in harness.cell_metrics(BENCH, cell, False)}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert harness.cell_metrics(BENCH, cell, True)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_per_layer_metric_moves_what_its_cells_report(metric):
    m = next(x for x in BENCH["per_layer"] if x["name"] == metric)
    for cell in m["workloads"]:
        assert m["moves"] in {x["name"] for x in harness.cell_metrics(BENCH, cell, False)}


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_config_file_states_what_the_program_runs(config):
    entry = next(c for c in BENCH["configs"] if c["name"] == config)
    cfg = harness.load_json(harness.ROOT / entry["file"])
    assert cfg["source"] == entry["source"] and cfg["reduced"] == entry["reduced"] == []
    from port_bench.program import program_config

    assert program_config(cfg, 3).model.num_towers == 3


def _program_modules(cfg_file):
    """The program's tower, ViT and text tower built on the meta device."""
    from safevla_tpu_torch.models.actor_critic import PolicyTower
    from safevla_tpu_torch.models.image_encoders import build_image_encoder
    from safevla_tpu_torch.models.text_towers import SigLIPTextEncoder, TextTowerConfig
    from port_bench.program import program_config

    cfg = program_config(cfg_file, 1)
    with torch.device("meta"):
        tower = PolicyTower(cfg.model)
        vit = build_image_encoder(cfg.model.vision_backbone)
        text = None
        if "text" in cfg_file and "num_layers" in cfg_file["text"]:
            t = cfg_file["text"]
            text = SigLIPTextEncoder(TextTowerConfig(d_model=t["d_model"], num_heads=t["num_heads"], max_tokens=t["max_tokens"]))
    return tower, vit, text


def _spec_of(module):
    return {k: (tuple(v.shape), str(v.dtype).split(".")[1]) for k, v in module.state_dict().items()}


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_parameter_specs_are_the_programs_at_full_size(config):
    cfg_file = harness.load_json(harness.BENCH_DIR / "configs" / f"{config}.json")
    tower, vit, text = _program_modules(cfg_file)
    as_dict = lambda spec: {n: (tuple(s), d) for n, s, d, _ in spec}
    assert as_dict(P.tower_spec(cfg_file["model"])) == _spec_of(tower)
    if not cfg_file["vision"]["cls_token"]:
        assert as_dict(P.vit_spec(cfg_file["vision"])) == _spec_of(vit)
    if text is not None:
        assert as_dict(P.text_spec(cfg_file["text"])) == _spec_of(text)


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_work_counts_are_the_programs_less_recompute(config):
    from safevla_tpu_torch.algo import flops as program_flops
    from port_bench.program import program_config

    cfg_file = harness.load_json(harness.BENCH_DIR / "configs" / f"{config}.json")
    m = cfg_file["model"]
    for towers in (1, 3):
        cfg = program_config(cfg_file, towers)
        b, t, epochs = 32, 128, cfg.ppo.update_repeats
        recompute = epochs * towers * program_flops._fusion_fwd_flops(cfg, b * t)
        assert FL.update_flops(m, towers, epochs, b, t) == pytest.approx(
            program_flops.update_flops_estimate(cfg, b, t) - recompute, rel=1e-12)
        b, t = 16, 50
        recompute = towers * program_flops._fusion_fwd_flops(cfg, b * t)
        assert FL.bc_step_flops(m, cfg_file["vision"], towers, b, t) == pytest.approx(
            program_flops.bc_step_flops_estimate(cfg, b, t) - recompute, rel=1e-12)


def test_nothing_of_the_benchmark_under_the_repository_tests():
    assert not list((harness.ROOT / "tests").glob("test_port_bench*"))


def test_reference_imports_nothing_of_the_program():
    for path in (harness.BENCH_DIR / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
        names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
        assert not [n for n in names if n.split(".")[0] in harness.FORBIDDEN + ("safevla_tpu_torch",)], path


def test_dataclass_fields_named_in_program_map_exist():
    from safevla_tpu_torch.config import ModelConfig
    from port_bench.program import MODEL_FIELDS

    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    assert set(MODEL_FIELDS.values()) <= fields
