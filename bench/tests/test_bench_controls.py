"""The controls at a size a test run holds: the reference in the program's
place with one of the configuration's guarantees broken has to come out not
correct, where the program comes out correct on the same inputs."""
import pytest
import torch

CPU = torch.device("cpu")


@pytest.mark.parametrize("cell", ["build_mapped_1M", "build_uniprotenc_150m"])
def test_the_control_fails_where_the_program_passes(tiny, cell):
    from bench import control

    got = dict(control.readings(tiny, cell, 2**31 + 5, CPU, program_seconds=0.3))
    (name,) = got["control"]
    assert got["control"][name]["value"] > got["control"][name]["limit"] == 0
    assert got["program"][name]["value"] == 0
