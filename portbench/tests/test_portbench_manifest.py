"""The manifest and the files it names: names, units, ``moves``, the cells
each metric reports in, one file per configuration, traffic mix, driver,
reader and set of limits; and the modules under ``portbench/`` reach
neither JAX nor the JAX package, and the reference none of the program."""

from __future__ import annotations

import ast
import json
import os
import re
import subprocess
import sys

import pytest

from portbench import harness as H

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
M = H.load_manifest()
E2E = {m["name"]: m for m in M["end_to_end"]}
CELLS = {w["name"]: w for w in M["workloads"]}
KINDS = sorted(os.path.splitext(f)[0] for f in os.listdir(os.path.join(H.BENCH_DIR, "kinds"))
               if f.endswith(".py"))


def reports(cell: str, metric: dict) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def test_top_level_keys_and_limits():
    assert set(M) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert M["paths"] == ["portbench"] and M["command"] == ["python3", "portbench/run.py"]
    assert 1 <= M["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (M["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(M)) <= 64 * 1024


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_unique_and_well_formed(kind):
    names = [e["name"] for e in M[kind]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_metrics_units_better_sources():
    for m in M["end_to_end"] + M["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in M["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert E2E["setup_s"]["bound"] == 0.25 and "workloads" not in E2E["setup_s"]
    for m in M["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in E2E and m["moves"] != "setup_s"
        if m["unit"] == "%" and ("roofline" in m["name"]):
            assert m["name"].split(".")[0].endswith("_roofline")


def test_every_cell_reports_what_its_metrics_move():
    for m in M["per_layer"]:
        for cell in m.get("workloads", CELLS):
            assert cell in CELLS
            assert reports(cell, E2E[m["moves"]]), (m["name"], cell)
    for cell in CELLS:
        e2e = [n for n, m in E2E.items() if reports(cell, m)]
        assert "setup_s" in e2e and len(e2e) >= 2, cell
        assert any(reports(cell, m) for m in M["per_layer"]), cell
    layers = {}
    for m in M["per_layer"]:
        layers.setdefault(m["layer"], set()).add(m["name"])
    assert all("\n" not in layer for layer in layers)


def test_every_name_has_its_files():
    for c in M["configs"]:
        path = os.path.join(H.REPO, c["file"])
        assert c["file"].startswith("portbench/") and os.path.exists(path)
        cfg = json.load(open(path))
        assert set(c["reduced"]) <= set(cfg) and len(c["reduced"]) <= 16
        assert c["source"].startswith("https://")
        assert os.path.exists(os.path.join(H.BENCH_DIR, "kinds", cfg["model"] + ".py"))
    files = [c["file"] for c in M["configs"]]
    assert len(files) == len(set(files))
    pairs = set()
    for w in M["workloads"]:
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert w["chips"] == 1 and len(w["why"]) <= 200
        traffic = json.load(open(os.path.join(H.BENCH_DIR, "traffic", w["traffic"] + ".json")))
        assert os.path.exists(os.path.join(H.BENCH_DIR, "drivers", traffic["driver"] + ".py"))
        assert os.path.exists(os.path.join(H.BENCH_DIR, "limits", w["name"] + ".json"))
    for m in M["per_layer"]:
        assert os.path.exists(os.path.join(H.BENCH_DIR, "metrics", m["name"] + ".py"))


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _py_files(root):
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_module_reaches_jax_or_the_jax_package():
    for path in _py_files(H.BENCH_DIR):
        for name in _imports(path):
            assert name.split(".")[0] not in H.FORBIDDEN_MODULES, (path, name)


def test_the_reference_reaches_nothing_of_the_program():
    for sub in ("ref", "judge"):
        for path in _py_files(os.path.join(H.BENCH_DIR, sub)):
            for name in _imports(path):
                assert name.split(".")[0] != "musicfpaugment_torch", (path, name)
    # every module of the reference and the judge, and each kind's
    # reference model and control
    code = ("import sys, pkgutil, importlib, portbench.ref as r, portbench.judge as j\n"
            "from portbench import inputs as I\n"
            "for pkg in (r, j):\n"
            "    for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
            "        importlib.import_module(m.name)\n"
            "for k in " + repr(KINDS) + ":\n"
            "    kind = I.kind({'model': k})\n"
            "    I.reference_model({'model': k, 'model_args': kind.TINY_ARGS}, 'cpu')\n"
            "    with kind.tf32():\n"
            "        pass\n"
            "print(sorted({n.split('.')[0] for n in sys.modules} & "
            "{'musicfpaugment_torch', 'musicfpaugment_tpu', 'jax', 'jaxlib', 'flax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=H.REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxtyping_lookalike", sys)
    monkeypatch.setitem(sys.modules, "musicfpaugment_torch", sys)
    assert H.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "musicfpaugment_tpu.core", sys)
    assert H.forbidden_loaded() == ["musicfpaugment_tpu"]
