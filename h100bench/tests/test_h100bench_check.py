"""The comparison that decides ``correct``, held to fail where it must.

Each test drives a whole run of the tiny cell on the CPU (``tiny.py``: the
same harness, serving path, store and check as the chip's cells; the look
for a card is skipped), once sound and once with the timed path broken
underneath in one way the cells can break:

- a token altered where it is produced (the decode step's logits rolled);
- a step that returns its state unchanged (a decode wave that writes no K
  or V into the cache);
- half of a wave left out (the second half of a wave's rows given the first
  half's logits);
- a loaded prefix wrong (the blocks an install scattered zeroed).

The exchange between chips is not a fault these one-chip cells can have.
The control, the reference computed in float8, has to come out not correct
too: its gap is the upper reading a limit is set below.
"""

import pytest
import torch

from h100bench import check, run as run_mod, serve
from h100bench.tests import tiny

SEED = 2**31 + 7


def _result(seconds=2.0):
    cell = tiny.cell()
    out = serve.run(cell, SEED, seconds, False, "cpu")
    line, _ = run_mod.result(cell, out, False, {"platform": "cpu"})
    return line, out


def test_sound_run_is_correct():
    line, out = _result()
    assert line["correct"], line["check"]
    assert out["tokens_compared"] >= check.SAMPLE_TOKENS // 2
    assert line["attempted"] > 0 and line["failed"] == 0
    assert list(line)[-1] == "check"


def test_token_altered_where_produced_is_not_correct(monkeypatch):
    from infinistore_tpu_torch import engine

    step_chunk = engine.WaveDecoder.step_chunk

    async def altered(self, tokens, positions, padded_table, priority=0):
        rows = await step_chunk(self, tokens, positions, padded_table, priority=priority)
        return torch.roll(rows, 1, dims=-1)

    monkeypatch.setattr(engine.WaveDecoder, "step_chunk", altered)
    line, _ = _result()
    assert not line["correct"]
    assert line["check"]["max_logit_gap"]["value"] > tiny.LIMIT


def test_decode_step_that_leaves_the_cache_unchanged_is_not_correct(monkeypatch):
    from infinistore_tpu_torch import engine

    verify_step_ragged = engine.verify_step_ragged

    def stateless(params, *args):
        args = list(args)
        caches = args[6]
        args[6] = [(k.clone(), v.clone()) for k, v in caches]
        logits, _ = verify_step_ragged(params, *args)
        return logits, caches

    monkeypatch.setattr(engine, "verify_step_ragged", stateless)
    line, _ = _result()
    assert not line["correct"]


def test_half_of_a_wave_left_out_is_not_correct(monkeypatch):
    from infinistore_tpu_torch import engine

    verify_step_ragged = engine.verify_step_ragged

    def half(params, tokens, *args):
        logits, caches = verify_step_ragged(params, tokens, *args)
        n = logits.shape[0]
        if n > 1:
            logits = logits.clone()
            logits[n // 2:] = logits[: n - n // 2]
        return logits, caches

    monkeypatch.setattr(engine, "verify_step_ragged", half)
    line, _ = _result()
    assert not line["correct"]


def test_wrong_loaded_prefix_is_not_correct(monkeypatch):
    from infinistore_tpu_torch import engine

    install_kv = engine.EngineKVAdapter.install_kv

    async def zeroed(self, prefetch, caches, block_table):
        out, tokens = await install_kv(self, prefetch, caches, block_table)
        ids = torch.as_tensor(block_table[: tokens // self.block_tokens], dtype=torch.long)
        for k, v in out:
            k[ids] = 0
            v[ids] = 0
        return out, tokens

    monkeypatch.setattr(engine.EngineKVAdapter, "install_kv", zeroed)
    line, out = _result()
    assert any(t.stats.loaded_blocks for t in out["run"].turns if t.ok)
    assert not line["correct"]


def test_control_in_float8_is_not_correct():
    cell = tiny.cell()
    out = serve.run(cell, SEED + 1, 2.0, False, "cpu")
    sample = check.sample(serve.served_turns(out["run"]), SEED + 1)
    gap = check.control_gap(serve.reference(cell, SEED + 1, "cpu"),
                            serve.reference(cell, SEED + 1, "cpu", quant="fp8"), sample)
    assert out["max_logit_gap"] <= tiny.LIMIT < gap


@pytest.mark.cuda
def test_mistral_cell_runs_correct_on_the_card():
    """On the card only: one short run of the Mistral cell, as its command
    runs it (``python -m pytest --noconftest -m cuda h100bench/tests``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    import json
    import subprocess
    import sys

    out = subprocess.run(
        [sys.executable, "-m", "h100bench.run", "--workload", "mistral7b.chat_sessions",
         "--seed", str(SEED), "--seconds", "10", "--trace", "0"],
        cwd=serve.spec.ROOT, capture_output=True, text=True, timeout=1500)
    assert out.returncode == 0, out.stderr[-4000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
