"""A cell at a size the CPU tests hold: the same harness, serving path and
check as the chip's cells, on a 2-layer float32 model with 3 sessions."""

import json
import os

from h100bench import spec

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                     "BENCHMARK.json")

# The CPU runs the program in float32: its gaps are round-off (about 1e-6);
# a wrong token or a wrong cache block reads tenths or more.
LIMIT = 1e-3


def _json(name):
    with open(os.path.join(DATA, name)) as f:
        return json.load(f)


def cell(limit: float = LIMIT, model_type: str = None) -> spec.Cell:
    """The tiny cell; ``model_type`` puts another architecture's module in
    place of the configuration's own (``llama``)."""
    bench = spec.load(BENCH)
    name = "tiny.chat_sessions"
    config = _json("tiny_config.json")
    if model_type is not None:
        config["model_type"] = model_type
    return spec.Cell(
        name=name, chips=1, config=config,
        traffic_params=_json("tiny_traffic.json"),
        limits={"max_logit_gap": limit},
        end_to_end=spec._metrics(bench["end_to_end"], name),
        per_layer=spec._metrics(bench["per_layer"], name),
    )
