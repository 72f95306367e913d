"""The control: the reference put in the program's place and computed
one precision below the configuration's bf16 (float8 e4m3 operands and
stored parameters) fails the cells' limits.  At smoke size on the CPU,
in the cells' bf16; the chip's readings at the cells' own sizes, from
which the limits were set, are in PERF.md."""
import pytest

from conftest import smoke_root
from portbench import compare, harness
from portbench.kinds import train


@pytest.mark.parametrize("name", ["mamba2-2.7b.train.k4-q09",
                                  "mistral-7b.train.text4k"])
def test_control_fails_the_limits(tmp_path, name):
    root = smoke_root(tmp_path, dtype="bfloat16")
    cell = harness.load_cell(f"{name}.smoke", root)
    got = train.readings(cell, 5, "cpu", controls=True)
    limits = cell["limits"]
    control = {n: {"value": v, "limit": limits[n]}
               for n, v in got["control_fp8"].items()}
    assert not compare.passes(control), control
