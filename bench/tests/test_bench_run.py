"""bench/run.py refuses to measure without the card, and without the
program beside it."""
import json
import os
import shutil
import subprocess
import sys

from bench.harness import ROOT


def run(cwd, script):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, script, "--workload", "mixtral-chat", "--seed",
         str(2**31 + 5), "--seconds", "1", "--trace", "0"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=120)


def no_result(out):
    for line in out.splitlines():
        try:
            json.loads(line)
        except ValueError:
            continue
        raise AssertionError(f"a result line was printed: {line}")


def test_no_card_exits_nonzero_with_a_message():
    r = run(ROOT, "bench/run.py")
    assert r.returncode != 0
    assert "CUDA device" in r.stderr and "Nothing was measured" in r.stderr
    no_result(r.stdout)


def test_benchmark_files_alone_exit_nonzero(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = run(tmp_path, "bench/run.py")
    assert r.returncode != 0
    no_result(r.stdout)
