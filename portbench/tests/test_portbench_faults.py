"""A run whose timed path is broken underneath comes out not correct: the
harness's look for a card is skipped (the micro cells run on the CPU) and
the rest of a run is driven as the benchmark drives it, with one fault of
portbench/faults.py planted in the program for the run."""

import pytest

from portbench import faults, harness
from portbench.tests.micro import micro_registry

SEED = 2 ** 32 + 99


def _run(reg, cell):
    r = harness.run_cell(reg, cell, SEED, 0.5, False, device="cpu")
    r.pop("_lines")
    return r


def test_sound_runs_are_correct(tmp_path):
    reg = micro_registry(tmp_path)
    assert _run(reg, "micro.swap_b1")["correct"]
    assert _run(reg, "micro.batch8")["correct"]


@pytest.mark.parametrize("fault,cells", [
    ("answer_altered", ("swap_b1", "batch8")),
    ("half_batch", ("batch8",)),
    ("kernel_skipped", ("swap_b1",)),
    ("blend_skipped", ("swap_b1",)),
])
def test_a_planted_fault_is_not_correct(tmp_path, fault, cells):
    reg = micro_registry(tmp_path, traffics=cells)
    with faults.planted(fault):
        for t in cells:
            assert not _run(reg, f"micro.{t}")["correct"], t


def test_faults_leave_the_program_as_it_was():
    import hairfastgan_torch.pipeline.blending as blending

    plain = blending.dilate_erode
    with faults.planted("masks_rolled"):
        assert blending.dilate_erode is not plain
    assert blending.dilate_erode is plain
