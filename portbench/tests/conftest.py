"""Put the checkout's root (for ``portbench``) and ``src`` (for the port)
on the import path, and build the small cells the CPU tests run."""
import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
for p in (str(REPO / "src"), str(REPO)):
    if p not in sys.path:
        sys.path.insert(0, p)

#: the port's smoke sizes of the two families, with the cells' traffic
#: cut to match (sequences of 64 and 32)
SMOKE = {
    "mamba2": {"num_layers": 2, "d_model": 128, "vocab_size": 512,
               "ssm_state": 16, "ssm_head_dim": 32, "ssm_chunk": 32},
    "mistral": {"num_layers": 2, "d_model": 256, "num_heads": 8,
                "num_kv_heads": 2, "head_dim": 32, "d_ff": 512,
                "vocab_size": 512},
}
SMOKE_TRAFFIC = {"mamba2": {"seq": 64}, "mistral": {"seq": 32}}


def smoke_root(tmp: Path, dtype: str = "float32") -> Path:
    """A copy of the benchmark's data folders with a smoke-size cell
    ``<cell>.smoke`` beside each cell, holding the cell's own limits."""
    from portbench import harness

    root = tmp / "portbench"
    for sub in ("cells", "configs", "traffic", "metrics"):
        shutil.copytree(harness.ROOT / sub, root / sub)
    for name in harness.cell_names(harness.ROOT):
        cell = harness.load_cell(name)
        family = cell["config"]["family"]
        config = json.loads((root / "configs" /
                             f"{cell['config']['name']}.json").read_text())
        config["model"].update(SMOKE[family], dtype=dtype)
        traffic = dict(json.loads((root / "traffic" /
                                   f"{cell['traffic']['name']}.json")
                                  .read_text()), **SMOKE_TRAFFIC[family])
        small = f"{name}.smoke"
        (root / "configs" / f"{small}.json").write_text(json.dumps(config))
        (root / "traffic" / f"{small}.json").write_text(json.dumps(traffic))
        (root / "cells" / f"{small}.json").write_text(json.dumps(
            dict(json.loads((root / "cells" / f"{name}.json").read_text()),
                 config=small, traffic=small)))
    return root


@pytest.fixture
def smoke(tmp_path):
    return smoke_root(tmp_path)
