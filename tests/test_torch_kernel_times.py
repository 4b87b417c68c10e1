"""The kernel timing script's host side: its summary of two trees' runs, and
its refusal without a CUDA device."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

from worddiffusion_tpu_torch import kernel_times

SCRIPT = Path(kernel_times.__file__)
METHODS = ("single_ms", "launch_ms", "kernel_ms")


def _run(tree, kernel, library):
    row = dict(shape=[128, 256, 811], kernel={m: kernel for m in METHODS},
               library={m: library for m in METHODS})
    return dict(tree=tree, attention=[row], conv=[])


def test_summary_means_each_trees_runs_and_divides_other_by_this():
    runs = [_run("parent", 0.6, 0.1), _run("this", 0.1, 0.12), _run("this", 0.2, 0.12),
            _run("parent", 0.6, 0.1)]
    (line,) = kernel_times.summary(runs)
    assert line.startswith("attention [128, 256, 811]: ")
    for m in METHODS:
        assert f"{m} this 0.1500 other 0.6000 (4.00x) library 0.1200" in line


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a card")
def test_refuses_without_cuda(tmp_path):
    res = subprocess.run([sys.executable, str(SCRIPT), "--out", str(tmp_path / "t.json")],
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert "needs a CUDA device" in res.stderr
    assert not (tmp_path / "t.json").exists()
