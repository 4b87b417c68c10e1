"""The kernel timing script's host side: its shape lists against the
smoke run's, its summary of two trees' runs, and its refusal without a CUDA
device."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

import chip_smoke
from worddiffusion_tpu_torch import kernel_times

SCRIPT = Path(kernel_times.__file__)
METHODS = kernel_times.METHODS


def _run(tree, kernel, library):
    row = dict(shape=[128, 256, 811], kernel={m: kernel for m in METHODS},
               library={m: library for m in METHODS})
    return dict(tree=tree, attention=[row], conv=[])


def test_shapes_cover_the_smoke_runs_unet_sites():
    """Every B.1 and B.3 M, every UNet B.5 site (8x32 and 4x16, 320 and 640
    channels, B=16 and 128) and every fold sub-layer of the main path (B.8 at
    L=42, and B.7's layout at both batches) that chip_smoke.py names is timed,
    so that the before/after table covers the main path's shapes."""
    assert set(chip_smoke.FFN_SHAPES) <= set(kernel_times.FFN_M)
    assert set(chip_smoke.BWD_SHAPES) <= set(kernel_times.FFN_BWD_M)
    folds = {(b, n) for b, n, l in chip_smoke.FOLD_SHAPES if l == kernel_times.FOLD_L}
    assert len(folds) == 4 and folds <= set(kernel_times.FOLD_BN)
    assert {b for b, _ in kernel_times.FOLD_B7_BN} == {chip_smoke.B, chip_smoke.TRAIN_B}
    assert chip_smoke.TRAIN_B * 256 in kernel_times.FFN_M
    unet = {s for s in chip_smoke.GN_SHAPES if s[1:3] in ((8, 32), (4, 16)) and s[3] in (320, 640)}
    assert len(unet) == 10 and unet <= set(kernel_times.GN_SHAPES)
    # and one site whose per-CTA range does not fit in shared memory even at
    # the largest cluster (8 CTAs of at most 112 KB)
    assert any(h * w * c * 2 > 8 * 112 * 1024 for _, h, w, c, _, _ in kernel_times.GN_SHAPES)


def test_conv_shapes_cover_both_unet_resolutions_at_both_batches():
    """B.6 is timed at the UNet's 8 x 32 and 4 x 16 sites at B=16 and 128 (the
    4 x 16 ones take the K-split plan), as chip_smoke.py drives them, and at
    a pixel-space ResBlock's [16, 64, 256, 320]; B.3 at the training sites."""
    unet = {s[:4] for s in chip_smoke.CONV_SHAPES if s[1:3] in ((8, 32), (4, 16)) and s[3] == 320}
    assert unet == {(b, h, w, 320) for b in (chip_smoke.B, chip_smoke.TRAIN_B)
                    for h, w in ((8, 32), (4, 16))}
    assert unet <= set(kernel_times.CONV_SHAPES)
    assert (chip_smoke.B, 64, 256, 320) in kernel_times.CONV_SHAPES
    assert {s[:4] for s in chip_smoke.PIXEL_CONV_SHAPES} & set(kernel_times.CONV_SHAPES)
    assert {chip_smoke.TRAIN_B * 256, chip_smoke.TRAIN_B * 64} <= set(kernel_times.FFN_BWD_M)


def test_wide_shapes_cover_the_smoke_runs_wide_rows():
    """B.3 is timed at every width and (1, 2) training site chip_smoke.py's
    phase 35 holds against plain, and the fold at its C = 640 shapes."""
    assert set(chip_smoke.BWD_WIDE_SHAPES) <= set(kernel_times.FFN_BWD_WIDE)
    assert {d for _, d in kernel_times.FFN_BWD_WIDE} == set(range(64, 769, 64))
    assert chip_smoke.FOLD_WIDE_C == kernel_times.FOLD_WIDE_C
    assert set(chip_smoke.FOLD_WIDE_SHAPES) <= set(kernel_times.FOLD_WIDE_BN)
    assert "ffn_bwd_wide" in kernel_times.KINDS and "fold_wide" in kernel_times.KINDS


def test_ffn_bwd_shapes_cover_the_pixel_sites():
    """B.3 is timed at pixel space's two sites (B=16 at 64 x 256 and 32 x 128
    tokens), as chip_smoke.py drives them, beside the training step's."""
    assert set(chip_smoke.PIXEL_FFN_M) <= set(kernel_times.FFN_BWD_M)
    assert chip_smoke.B * 64 * 256 in kernel_times.FFN_BWD_M


def test_summary_handles_every_kind_with_and_without_a_library():
    """B.1 and B.2 have no library call (None): their lines leave it out;
    B.5's carries F.group_norm's."""
    def run(tree, t):
        row = lambda shape, lib: dict(shape=shape, kernel={m: t for m in METHODS},
                                      library=None if lib is None else {m: lib for m in METHODS})
        return dict(tree=tree, attention=[], conv=[], ffn=[row([4096], None)],
                    geglu=[row([32768], None)], groupnorm=[row([16, 8, 32, 640, 32, True], 0.06)])

    lines = kernel_times.summary([run("parent", 0.3), run("this", 0.1), run("this", 0.1),
                                  run("parent", 0.3)])
    assert [ln.split(":")[0] for ln in lines] == [
        "ffn [4096]", "geglu [32768]", "groupnorm [16, 8, 32, 640, 32, True]"]
    assert "library" not in lines[0] and "library" not in lines[1]
    for m in METHODS:
        assert f"{m} this 0.1000 other 0.3000 (3.00x) library 0.0600" in lines[2]


def test_summary_means_each_trees_runs_and_divides_other_by_this():
    runs = [_run("parent", 0.6, 0.1), _run("this", 0.1, 0.12), _run("this", 0.2, 0.12),
            _run("parent", 0.6, 0.1)]
    (line,) = kernel_times.summary(runs)
    assert line.startswith("attention [128, 256, 811]: ")
    for m in METHODS:
        assert f"{m} this 0.1500 other 0.6000 (4.00x) library 0.1200 runs this " \
               "0.1000-0.2000 other 0.6000-0.6000" in line


def test_conv_shapes_cover_the_wide_unets_middle_sites():
    """B.6 is timed (and its plans swept) at the 640-wide 4 x 16 sites of
    channel_mult=(1, 2) at both batches, where the plan keeps the statistics
    in the kernel."""
    assert {(chip_smoke.B, 4, 16, 640), (chip_smoke.TRAIN_B, 4, 16, 640)} <= set(
        kernel_times.CONV_SHAPES)


def test_takes_lets_only_the_other_tree_refuse_a_width():
    """A width the other (earlier) tree's kernel refuses is recorded as not
    taken; this tree's refusal raises."""
    def refuse():
        raise ValueError("kernel needs d % 64 == 0 with 64 <= d <= 320")

    assert kernel_times.takes(refuse, may_refuse=True) is None
    with pytest.raises(ValueError, match="kernel needs"):
        kernel_times.takes(refuse, may_refuse=False)


@pytest.mark.parametrize("rounds", [1, 2])
def test_run_order_balances_the_trees(rounds):
    """Each tree runs 2 * rounds times, this tree's first run is the deep
    one and the only one, and with two rounds each tree runs first once."""
    order = kernel_times.run_order("this", "other", rounds)
    assert len(order) == 4 * rounds
    for tree in ("this", "other"):
        assert sum(t == tree for t, _ in order) == 2 * rounds
    assert [(t, d) for t, d in order if d] == [("this", True)]
    firsts = {order[4 * r][0] for r in range(rounds)}
    assert firsts == ({"other"} if rounds == 1 else {"this", "other"})
    assert kernel_times.run_order("this", None) == [("this", True)]


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a card")
def test_refuses_without_cuda(tmp_path):
    res = subprocess.run([sys.executable, str(SCRIPT), "--out", str(tmp_path / "t.json")],
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert "needs a CUDA device" in res.stderr
    assert not (tmp_path / "t.json").exists()
