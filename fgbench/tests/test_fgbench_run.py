"""The entry point's refusals: no card, no port, no such cell.  Each exits
with a code other than 0 and prints no result."""

import os
import shutil
import subprocess
import sys

import pytest
import torch

from fgbench import run
from fgbench.spec import ROOT

ARGS = ["--workload", "c4-1080p-4k.live30", "--seed", str(2 ** 31 + 3),
        "--seconds", "1", "--trace", "0"]


def test_no_card_fails_with_a_message(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(ARGS) == 2
    out, err = capsys.readouterr()
    assert out == ""
    assert "no CUDA device" in err and "times the card only" in err


def test_too_few_cards_fail(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert run.main(ARGS) == 2
    out, err = capsys.readouterr()
    assert out == "" and "needs 1 CUDA devices, 0 present" in err


def test_an_unknown_cell_fails(capsys):
    assert run.main(["--workload", "nope", "--seed", "1", "--seconds",
                     "1"]) == 2
    out, err = capsys.readouterr()
    assert out == "" and "no workload 'nope'" in err


def test_the_benchmark_alone_runs_nothing(tmp_path):
    # a directory with BENCHMARK.json and fgbench/ only: no port to run
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "fgbench"), tmp_path / "fgbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "fgbench/run.py", *ARGS],
                       cwd=tmp_path, capture_output=True, text=True,
                       env=env, timeout=120)
    assert p.returncode != 0 and p.stdout == ""
    assert "fgbench:" in p.stderr


@pytest.mark.parametrize("bad", [["--trace", "2"], ["--seed", "x"]])
def test_bad_arguments_exit(bad):
    with pytest.raises(SystemExit):
        run.parse_args(ARGS + bad)


def test_openmp_workers_do_not_spin():
    # set by the entry point before torch is imported: spinning workers
    # took most of the host's cores from the engine's thread
    p = subprocess.run(
        [sys.executable, "-c",
         "import runpy, os, sys; sys.argv = ['run.py', '--help'];\n"
         "try:\n"
         "    runpy.run_path('fgbench/run.py', run_name='__main__')\n"
         "except SystemExit:\n"
         "    pass\n"
         "print(os.environ['OMP_WAIT_POLICY'], 'torch' in sys.modules)"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert p.stdout.split()[-2:] == ["PASSIVE", "True"]
