"""CPU tests of the benchmark's parts: the traffic generator, the files
BENCHMARK.json names, the roofline arithmetic, the metric readers on
recorded stats, the trace reduction, and what the run and the reference
import.

Run: ``python -m pytest h100bench/tests -q`` from the repository's root.
"""

import asyncio
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import pytest

from h100bench import arch, records, roofline, spec, trace
from h100bench.generators import sessions

ROOT = spec.ROOT
TRAFFIC = os.path.join(spec.HERE, "traffic", "chat_sessions.json")


def _traffic():
    with open(TRAFFIC) as f:
        return json.load(f)


def _config(name):
    with open(os.path.join(spec.HERE, "configs", name + ".json")) as f:
        return json.load(f)


def _shapes(name):
    """The work object of a configuration, through its architecture."""
    cfg = _config(name)
    return arch.find(cfg["model_type"]).shapes(cfg)


# -- the generator -----------------------------------------------------------


def _drive(gen, turns_wanted=60):
    """Drive the sessions with a stand-in engine that answers at once with
    ``gen`` tokens of its own; returns the (prompt, gen) turns sent."""
    sent = []

    async def send(prompt, n):
        sent.append((list(prompt), n))
        await asyncio.sleep(0)
        return [(len(prompt) + i) % 7 for i in range(n)]

    asyncio.run(gen.drive(send, lambda: len(sent) < turns_wanted))
    return sent


@pytest.mark.parametrize("config", ["mistral-7b-v0.3", "phi-3-mini-4k"])
def test_sessions_are_block_aligned_and_within_the_cap(config):
    cfg = _config(config)
    gen = sessions.build(_traffic(), 2**31 + 99, cfg["vocab_size"], cfg["max_context"],
                         cfg["block_tokens"])
    for prompt, n in _drive(gen):
        assert len(prompt) % 16 == 0 and n % 16 == 0
        assert len(prompt) + n <= cfg["max_context"]
        assert all(0 <= t < cfg["vocab_size"] for t in prompt)


def test_sessions_follow_up_extends_the_previous_prompt():
    cfg = _config("mistral-7b-v0.3")
    gen = sessions.build(_traffic(), 5, cfg["vocab_size"], cfg["max_context"], 16)
    sent = _drive(gen, 200)
    system = gen.system
    by_prefix = 0
    for i, (prompt, _) in enumerate(sent):
        assert prompt[:512] == system  # every turn opens with the shared system prompt
        # A follow-up's prompt is an earlier turn's prompt plus that turn's
        # answer plus a new user turn.
        for prev, n in sent[:i]:
            answer = [(len(prev) + j) % 7 for j in range(n)]
            if len(prompt) > len(prev) + n and prompt[:len(prev) + n] == prev + answer:
                by_prefix += 1
                break
    assert by_prefix > len(sent) // 2


def test_sessions_are_deterministic_from_the_seed():
    cfg = _config("phi-3-mini-4k")
    a = sessions.build(_traffic(), 123456789012, cfg["vocab_size"], cfg["max_context"], 16)
    b = sessions.build(_traffic(), 123456789012, cfg["vocab_size"], cfg["max_context"], 16)
    c = sessions.build(_traffic(), 123456789013, cfg["vocab_size"], cfg["max_context"], 16)
    assert [a.user_turns(k) for k in range(20)] == [b.user_turns(k) for k in range(20)]
    assert [a.shape_of(k) for k in range(40)] == [b.shape_of(k) for k in range(40)]
    assert a.system != c.system
    # Every seed runs the same sizes: each round of `templates` sessions is
    # every shape once, in an order of the seed's.
    n = len(a.shapes)
    for r in range(3):
        got = sorted(map(tuple, (map(tuple, c.shape_of(r * n + i)) for i in range(n))))
        assert got == sorted(map(tuple, (map(tuple, s) for s in a.shapes)))
    assert [a.shape_of(k) for k in range(n)] != [c.shape_of(k) for k in range(n)]


def test_sessions_in_flight_at_the_start_open_at_spread_depths():
    cfg = _config("mistral-7b-v0.3")
    p = _traffic()
    gen = sessions.build(p, 77, cfg["vocab_size"], cfg["max_context"], 16)
    n = p["sessions_in_flight"]
    firsts = []
    for k in range(n + 3):
        first, history = gen.opening(k)
        turns = gen.shape_of(k)
        assert first == (k * len(turns) // n if k < n else 0)
        users = gen.user_turns(k)
        assert history[:512] == gen.system
        assert len(history) == 512 + sum(len(users[t]) + turns[t][1] for t in range(first))
        if first:
            assert history[512:512 + len(users[0])] == users[0]
        assert gen.opening(k) == (first, history)  # drawn from the seed alone
        firsts.append(first)
    assert firsts[n:] == [0, 0, 0] and len(set(firsts[:n])) > 3


def test_session_shapes_follow_the_traffic_file():
    p = _traffic()
    shapes = sessions.session_shapes(p, 4096, 16)
    assert len(shapes) == p["templates"]
    for turns in shapes:
        assert 1 <= len(turns) <= p["max_turns"]
        for user, answer in turns:
            assert 32 <= user <= 1024 and 16 <= answer <= 256


# -- BENCHMARK.json ----------------------------------------------------------


def test_every_name_in_benchmark_json_resolves_to_its_file():
    bench = spec.load()
    for conf in bench["configs"]:
        assert os.path.isfile(os.path.join(ROOT, conf["file"])), conf["file"]
    for w in bench["workloads"]:
        cell = spec.cell(bench, w["name"])
        assert os.path.isfile(os.path.join(spec.HERE, "generators",
                                           cell.traffic_params["generator"] + ".py"))
        assert cell.limits["max_logit_gap"] > 0
        for m in cell.end_to_end + cell.per_layer:
            assert os.path.isfile(m.path), m.path
        names = {m.name for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2 and cell.per_layer
    for m in bench["per_layer"]:
        moved = [e for e in bench["end_to_end"] if e["name"] == m["moves"]]
        assert moved, m["name"]


def test_configs_hold_the_published_widths():
    m = _config("mistral-7b-v0.3")
    assert (m["hidden_size"], m["num_hidden_layers"], m["num_attention_heads"],
            m["num_key_value_heads"], m["intermediate_size"], m["vocab_size"]) == (
        4096, 32, 32, 8, 14336, 32768)
    p = _config("phi-3-mini-4k")
    assert (p["hidden_size"], p["num_hidden_layers"], p["num_attention_heads"],
            p["num_key_value_heads"], p["intermediate_size"], p["vocab_size"]) == (
        3072, 32, 32, 32, 8192, 32064)
    # The traffic keeps every query under Phi-3's sliding window.
    assert p["max_context"] <= p["sliding_window"]


# -- the roofline arithmetic --------------------------------------------------


def test_roofline_against_hand_values():
    m = _shapes("mistral-7b-v0.3")
    p = _shapes("phi-3-mini-4k")
    # Mistral: per layer q 4096x4096, k and v 4096x1024, o 4096x4096, gate,
    # up and down 4096x14336: 218,103,808; x 32 layers x 2 FLOPs.
    assert m.matmul_params() == 6_979_321_856
    assert 2 * m.matmul_params() / 1e9 == pytest.approx(13.96, abs=0.005)
    # Phi-3: 4 x 3072^2 + 3 x 3072 x 8192 = 113,246,208 a layer.
    assert p.matmul_params() == 3_623_878_656
    assert m.kv_bytes_per_token() == 128 << 10
    assert p.kv_bytes_per_token() == 384 << 10
    assert m.block_bytes() == 2 << 20 and p.block_bytes() == 6 << 20
    # One decode row at position 1023 reads 1,024 tokens of KV (128 MiB)
    # plus q and out (32 layers x 2 x 4096 x 2 bytes).
    nbytes, flops = m.decode_attention_work(1023)
    assert nbytes == 1024 * (128 << 10) + 32 * 2 * 4096 * 2
    assert flops == 4 * 32 * 32 * 128 * 1024
    assert roofline.least_s(nbytes, flops) == pytest.approx(nbytes / 3.35e12)
    # A resumed suffix of 2 rows after 3 tokens: 4 + 5 keys.
    nbytes, flops = m.resume_attention_work(3, 2)
    assert flops == 4 * 32 * 32 * 128 * 9
    assert nbytes == 5 * (128 << 10) + 2 * 32 * 2 * 4096 * 2
    # A prefill of 3 tokens from 0: 1 + 2 + 3 keys, one logits row.
    assert m.prefill_flops(0, 3, 1) == pytest.approx(
        3 * 2 * m.matmul_params() + 4 * 32 * 32 * 128 * 6 + 2 * 4096 * 32768)
    assert m.token_flops(10, True) == pytest.approx(m.prefill_flops(9, 1, 1))


# -- the metric readers -------------------------------------------------------


def _stats(loaded, computed, ttft_us, gate_us, fetch_us=0.0, hold_us=0.0, ready_us=0.0):
    return SimpleNamespace(loaded_blocks=loaded, computed_blocks=computed, ttft_us=ttft_us,
                           gate_stall_us=gate_us, fetch_us=fetch_us, gate_hold_us=hold_us,
                           prefix_ready_us=ready_us)


def _run():
    s = _shapes("mistral-7b-v0.3")
    t1 = records.Turn(prompt=[0] * 64, gen=3, t_send=9.0, t_return=10.5,
                      steps=[records.Step(63, 10.0), records.Step(64, 10.2),
                             records.Step(65, 10.4), records.Step(66, 10.45)],
                      stats=_stats(3, 1, 1e6, 2.5e5, fetch_us=1e5, hold_us=1e5, ready_us=0.5e6),
                      generated=[1, 2, 3])
    t2 = records.Turn(prompt=[0] * 32, gen=2, t_send=10.6, t_return=12.5,
                      steps=[records.Step(31, 11.0), records.Step(32, 11.5)],
                      stats=_stats(0, 2, 4e5, 0.0, ready_us=0.3e6), generated=[4, 5])
    t3 = records.Turn(prompt=[0] * 16, gen=2, t_send=11.0, t_return=11.1, error="boom")
    return records.Run(shapes=s, start=10.0, end=12.0, turns=[t1, t2, t3],
                       saves=[(10.0, 10.5, 4 << 20), (11.0, 13.0, 1 << 20)],
                       loads=[(10.1, 10.2, 6 << 20)], setup_s=33.0)


def _metric(name):
    bench = spec.load()
    entry = [m for m in bench["end_to_end"] + bench["per_layer"] if m["name"] == name][0]
    return spec.Metric(name, entry["unit"], os.path.join(spec.HERE, "metrics", name + ".py"))


def test_end_to_end_readers_on_recorded_turns():
    run = _run()
    assert [t.error for t in run.sent()] == [None, "boom"]  # t2, t3 sent in the window
    assert _metric("setup_s").read(run) == 33.0
    # first tokens in the window: t1 (10.0 - 9.0 = 1.0 s) and t2 (0.4 s)
    assert _metric("engine.ttft_p50_ms").read(run) == pytest.approx(700.0)
    assert _metric("engine.ttft_p90_ms").read(run) == pytest.approx(940.0)
    # returned in the window: t1, sent at 9.0 and back at 10.5; (10.5 - 10.0) / 2 = 0.25 s
    assert _metric("turn_p50_ms").read(run) == pytest.approx(1500.0)
    assert _metric("engine.tpot_p90_ms").read(run) == pytest.approx(250.0)
    # tokens stamped in the window: t1's three (the fourth step emits none), t2's two
    assert _metric("engine.output_tokens_per_s").read(run) == pytest.approx(5 / 2.0)


def test_per_layer_readers_on_recorded_turns():
    run = _run()
    s = run.shapes
    assert _metric("engine.gate_wait_share").read(run) == pytest.approx(100 * 2.5e5 / 1.4e6)
    assert _metric("engine.hit_block_share").read(run) == pytest.approx(100 * 3 / 6)
    assert _metric("store.load_GBps").read(run) == pytest.approx(3 * (2 << 20) / 0.2 / 1e9)
    # only the save that ended in the window
    assert _metric("store.save_GBps").read(run) == pytest.approx((4 << 20) / 0.5 / 1e9)
    # t1 became resident at 9.5 (before the window): its steps 2-4 count
    # (logits for the 2nd and 3rd, none for the 4th); t2 resident at 10.9,
    # its second step counts.
    flops = (s.token_flops(65, True) + s.token_flops(66, True)
             + s.token_flops(67, False) + s.prefill_flops(0, 32, 1)
             + s.token_flops(33, True))
    assert _metric("model.mfu").read(run) == pytest.approx(100 * flops / (2.0 * 989e12))
    assert _metric("kernel.decode_attention_roofline").read(run) is None  # no trace
    run.trace = trace.Summary(window_s=2.0, busy_s=0.5,
                              kernel_s={"decode_attention": 1e-3, "block_copy": 2e-3},
                              device_ops=[], idle_gaps=[], events=3)
    run.trace_span = (10.0, 12.0)
    least = sum(roofline.least_s(*s.decode_attention_work(p))
                for p in (64, 65, 66, 31, 32))
    assert _metric("kernel.decode_attention_roofline").read(run) == pytest.approx(
        100 * least / 1e-3)
    assert _metric("kernel.block_copy_roofline").read(run) == pytest.approx(
        100 * 2 * ((4 << 20) + (6 << 20)) / 3.35e12 / 2e-3)
    assert _metric("device.idle_share").read(run) == pytest.approx(75.0)


# -- the trace reduction ------------------------------------------------------


def test_trace_reduce_busy_gaps_and_classes():
    ev = [
        trace.Event("void paged_decode_ragged<__nv_bfloat16, 128, 4>(float*)", 1.0, 0.5),
        trace.Event("void paged_decode<__nv_bfloat16, 128, 4>(float*)", 1.2, 0.5),
        trace.Event("void bulk_copy(Table, int)", 3.0, 0.25),
        trace.Event("sm90_xmma_gemm_bf16bf16", 5.5, 1.0),  # clipped at 6.0
    ]
    spans = [("save", 2.0, 2.9), ("decode_step", 0.0, 1.0)]
    s = trace.reduce(ev, 0.5, 6.0, spans)
    assert s.window_s == pytest.approx(5.5)
    assert s.busy_s == pytest.approx(0.7 + 0.25 + 0.5)
    assert s.kernel_s["decode_attention"] == pytest.approx(1.0)
    assert s.kernel_s["block_copy"] == pytest.approx(0.25)
    assert s.device_ops[0][0] == "paged_decode_ragged"
    gaps = dict(s.idle_gaps)
    assert gaps["decode_step"] == pytest.approx(0.5)  # 0.5-1.0
    assert gaps["save"] == pytest.approx(1.3)  # 1.7-3.0, midpoint 2.35
    assert gaps["no call in flight"] == pytest.approx(2.25)  # 3.25-5.5


# -- what is imported ---------------------------------------------------------


def _modules_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, check=True, timeout=600,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_imports_nothing_of_the_port():
    mods = _modules_after(
        "import json, torch\n"
        "from h100bench import arch, check\n"
        "cfg = json.load(open('h100bench/tests/data/tiny_config.json'))\n"
        "ref = arch.find(cfg['model_type']).reference(cfg, 5, 'cpu', torch.float32)\n"
        "assert ref.logits([[1, 2, 3]], [[2]])[0].shape == (1, cfg['vocab_size'])\n")
    assert not mods & {"infinistore_tpu_torch", "infinistore_tpu", "jax", "jaxlib", "flax"}
    src = os.path.join(spec.HERE, "reference")
    for name in os.listdir(src):
        if name.endswith(".py"):
            with open(os.path.join(src, name)) as f:
                assert "infinistore" not in f.read().replace("infinistore-tpu", ""), name


def test_a_run_imports_neither_jax_nor_the_jax_package():
    mods = _modules_after(
        "from h100bench import serve\n"
        "from h100bench.tests import tiny\n"
        "out = serve.run(tiny.cell(), 11, 1.0, False, 'cpu')\n"
        "assert out['tokens_compared'] > 0\n")
    assert "infinistore_tpu_torch" in mods
    assert not mods & {"infinistore_tpu", "jax", "jaxlib", "flax"}


def test_banned_modules_compares_whole_top_level_names(monkeypatch):
    from h100bench import run

    monkeypatch.setitem(sys.modules, "infinistore_tpu_torch_fake", SimpleNamespace())
    assert "infinistore_tpu" not in run.banned_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.fake", SimpleNamespace())
    assert "jaxlib" in run.banned_modules()
