"""CPU tests of the architecture route (``arch/``): the configuration's
``model_type`` finds its module, the Llama block's weights and reference
are those the benchmark drew before the route existed, and an architecture
added as a file alone runs a cell.

Run: ``python -m pytest h100bench/tests -q`` from the repository's root.
"""

import hashlib
import importlib
import json
import os
import sys

import pytest
import torch

from h100bench import arch, run as run_mod, serve, spec, trace
from h100bench.arch import llama
from h100bench.tests import tiny

SEED = 2**31 + 7


def _tiny_config():
    with open(os.path.join(tiny.DATA, "tiny_config.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("model_type", ["llama", "mistral", "phi3"])
def test_llama_block_model_types_resolve_to_the_llama_module(model_type):
    mod = arch.find(model_type)
    for name in ("shapes", "program", "params", "reference"):
        assert getattr(mod, name) is getattr(llama, name), name


def test_unknown_model_type_fails_at_once_naming_the_known_ones():
    with pytest.raises(KeyError) as err:
        tiny.cell(model_type="afmoe")
    for name in ("llama", "mistral", "phi3"):
        assert repr(name) in str(err.value)
    assert "'afmoe'" in str(err.value)


# -- the Llama block, bit for bit as before the route -------------------------

# SHA-256 (first 32 hex digits) of the tiny configuration's weights and
# reference logits at SEED, as the benchmark made them before the route:
# ``weights.params(roofline.Shapes.of(cfg), ...)`` and ``Reference(shapes,
# rope_theta, rms_norm_eps, seed, "cpu", weight_dtype=...)``. Tensors widened
# to float32, in the parameter dict's order.
_BEFORE = {
    "params_float32": "97d8110761278247634126f90411b37b",
    "params_bfloat16": "d5533fb6cc23afe526b3bbc518130e9a",
    "logits_float32": "f21861ffcb2bbd9412f764343560a8bc",
    "logits_bfloat16": "17f0f2a3bc3e7fa4af0d374101d2ce02",
    "logits_fp8": "d55b2faf572912c93d4476ddf4270e05",
}


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().float().contiguous().numpy().tobytes())
    return h.hexdigest()[:32]


def _sequences(vocab):
    seqs = [[(7 * i + 3) % vocab for i in range(40)], [(5 * i + 1) % vocab for i in range(23)]]
    return seqs, [list(range(30, 40)), [0, 5, 22]]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_llama_weights_and_reference_are_bit_for_bit_those_before_the_route(dtype):
    cfg = _tiny_config()
    mod = arch.find(cfg["model_type"])
    wdtype = getattr(torch, dtype)
    p = mod.params(cfg, SEED, "cpu", wdtype)
    assert list(p)[:3] == ["embed", "final_norm", "lm_head"] and list(p)[3] == "l0.attn_norm"
    assert _digest(p.values()) == _BEFORE["params_" + dtype]
    seqs, rows = _sequences(cfg["vocab_size"])
    got = mod.reference(cfg, SEED, "cpu", wdtype).logits(seqs, rows)
    assert _digest(got) == _BEFORE["logits_" + dtype]
    if dtype == "float32":
        control = mod.reference(cfg, SEED, "cpu", wdtype, quant="fp8").logits(seqs, rows)
        assert _digest(control) == _BEFORE["logits_fp8"]


# -- an architecture added as a file alone ------------------------------------

_DOUBLED = '''"""The Llama block with every work count doubled."""

from dataclasses import dataclass

from h100bench.arch import llama
from h100bench.arch.llama import params, program, reference  # noqa: F401


@dataclass(frozen=True)
class Doubled:
    s: llama.Shapes

    @property
    def block_tokens(self):
        return self.s.block_tokens

    def kv_bytes_per_token(self):
        return 2 * self.s.kv_bytes_per_token()

    def block_bytes(self):
        return 2 * self.s.block_bytes()

    def matmul_params(self):
        return 2 * self.s.matmul_params()

    def token_flops(self, context, logits):
        return 2 * self.s.token_flops(context, logits)

    def prefill_flops(self, start, n, logits_rows):
        return 2 * self.s.prefill_flops(start, n, logits_rows)

    def decode_attention_work(self, position):
        return tuple(2 * x for x in self.s.decode_attention_work(position))

    def resume_attention_work(self, start, n):
        return tuple(2 * x for x in self.s.resume_attention_work(start, n))


def shapes(cfg):
    return Doubled(llama.shapes(cfg))
'''


def _metric(name):
    bench = spec.load()
    entry = [m for m in bench["per_layer"] if m["name"] == name][0]
    return spec.Metric(name, entry["unit"], os.path.join(spec.HERE, "metrics", name + ".py"))


def test_an_architecture_added_as_a_file_alone_runs_the_cell(tmp_path, monkeypatch):
    (tmp_path / "doubled.py").write_text(_DOUBLED)
    monkeypatch.setattr(arch, "__path__", [str(tmp_path)] + list(arch.__path__))
    importlib.invalidate_caches()
    try:
        cell = tiny.cell(model_type="doubled")
        assert cell.arch.__file__ == str(tmp_path / "doubled.py")
        out = serve.run(cell, SEED, 2.0, False, "cpu")
        line, _ = run_mod.result(cell, out, False, {"platform": "cpu"})
        assert line["correct"], line["check"]
        run = out["run"]
        assert type(run.shapes).__name__ == "Doubled"
        run.trace = trace.Summary(window_s=run.seconds, busy_s=1.0,
                                  kernel_s={"decode_attention": 1e-3, "block_copy": 1e-3},
                                  device_ops=[], idle_gaps=[], events=1)
        run.trace_span = (run.start, run.end)
        names = ("model.mfu", "kernel.decode_attention_roofline")
        doubled = {n: _metric(n).read(run) for n in names}
        run.shapes = llama.shapes(cell.config)
        parent = {n: _metric(n).read(run) for n in names}
        for n in names:
            assert parent[n] and doubled[n] == 2 * parent[n], n
    finally:
        sys.modules.pop("h100bench.arch.doubled", None)
