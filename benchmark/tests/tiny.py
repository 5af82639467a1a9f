"""A cell at TINY_CONFIG's geometry, for the CPU tests."""

import json

from benchmark import spec
from zerovox_tpu_torch.config import TINY_CONFIG


def tiny_cell(name: str, **mix) -> spec.Cell:
    c = spec.cell(name)
    model = json.loads(TINY_CONFIG.to_json())
    model["compute_dtype"] = c.config["model"]["compute_dtype"]
    small = {"phonemes": [4, 16], "sample": 6}
    return c._replace(config=dict(c.config, model=model), mix={**c.mix, **small, **mix})
