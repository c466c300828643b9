"""A later change adds a configuration, a traffic mix, a cell and a metric
as new files and new entries of BENCHMARK.json, editing no file that is
there: the harness finds each by its name."""

import hashlib
import json
import os
import pathlib
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]


def _digests(top: pathlib.Path) -> dict:
    return {str(p.relative_to(top)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(top.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_new_files_are_found_by_name(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _digests(tmp_path / "benchmark")

    b = tmp_path / "benchmark"
    cfg = json.loads((b / "configs" / "sqiswap.json").read_text())
    cfg["name"] = "sqiswap_wide"
    (b / "configs" / "sqiswap_wide.json").write_text(json.dumps(cfg))
    traffic = json.loads((b / "traffic" / "haar.json").read_text())
    traffic.update(name="haar_tiny", batch=16, chunk=8, restarts=2, pool_batches=1)
    (b / "traffic" / "haar_tiny.json").write_text(json.dumps(traffic))
    (b / "metrics" / "batches_run.py").write_text("def read(ctx):\n    return len(ctx['batch_s'])\n")
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "sqiswap_wide", "source": "a test", "file": "benchmark/configs/sqiswap_wide.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "sqiswap_wide.haar_tiny", "config": "sqiswap_wide", "traffic": "haar_tiny",
                              "chips": 1, "why": "a test"})
    spec["end_to_end"].append({"name": "batches_run", "unit": "batches", "better": "higher", "bound": 0.01,
                               "source": "host_clock", "workloads": ["sqiswap_wide.haar_tiny"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    code = (
        f"import sys, json; sys.path[:0] = [{str(tmp_path)!r}, {str(ROOT)!r}]; import torch; "
        "torch.set_num_threads(2); from benchmark import harness; "
        "assert harness.__file__.startswith(sys.path[0]); "
        "r = harness.run('sqiswap_wide.haar_tiny', 11, 0.05, False, 'cpu', overrides={'check_per_batch': 4}, "
        "log=lambda *a, **k: None); print(json.dumps(r))"
    )
    # the copy holds no data: the reference and the port read the repository's cached sets
    env = {**os.environ, "SLAM_DATA_DIR": str(ROOT / "slam_decomposition_tpu" / "data")}
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True, text=True, timeout=600,
                         env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] is True and r["attempted"] == 16
    assert r["metrics"]["batches_run"] == {"value": 1, "unit": "batches"}
    assert "setup_s" in r["metrics"] and "certified_targets_per_s" not in r["metrics"]
    after = _digests(tmp_path / "benchmark")
    assert {k: v for k, v in after.items() if k in before} == before


def test_every_mix_names_a_flow_and_judge_that_exist():
    b = ROOT / "benchmark"
    mixes = sorted((b / "traffic").glob("*.json"))
    assert mixes
    for path in mixes:
        mix = json.loads(path.read_text())
        assert mix["name"] == path.stem
        assert (b / "traffic" / f"{mix['targets']}.py").is_file(), path.name
        assert (b / "flows" / f"{mix['flow']}.py").is_file(), path.name
        if "judge" in mix:
            assert (b / "reference" / f"{mix['judge']}.py").is_file(), path.name
