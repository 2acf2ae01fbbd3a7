"""CPU tests of the AFMoE architecture (``arch/afmoe.py``, ``reference/
afmoe.py``) and the two readers of the routed experts' kernel: the work
counts at a tiny size against counts made by hand, the readers on a recorded
run, and a tiny AFMoE cell through the whole harness.

Run: ``python -m pytest h100bench/tests -q`` from the repository's root.
"""

import json
import os
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch

from h100bench import arch, records, roofline, run as run_mod, serve, spec, trace
from h100bench.tests import tiny

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SEED = 2**31 + 13


def _tiny():
    with open(os.path.join(tiny.DATA, "tiny_afmoe_config.json")) as f:
        return json.load(f)


def _shapes():
    return arch.find("afmoe").shapes(_tiny())


def _metric(name):
    bench = spec.load()
    entry = [m for m in bench["per_layer"] if m["name"] == name][0]
    return spec.Metric(name, entry["unit"], os.path.join(spec.HERE, "metrics", name + ".py"))


# -- the work counts ----------------------------------------------------------


def test_matmul_params_are_the_program_weights_a_token_multiplies():
    """q, k, v, o, the gate; the dense SwiGLU on layers 0-1, the shared
    expert and 2 of the 8 routed ones on layers 2-5."""
    cfg = _tiny()
    mod = arch.find("afmoe")
    s = mod.shapes(cfg)
    p = mod.params(cfg, SEED, "cpu", torch.float32)
    want = 0
    for i in range(s.n_layers):
        pre = f"l{i}."
        for name in ("wq", "wk", "wv", "wo", "w_attn_gate"):
            want += p[pre + name].numel()
        if i < s.n_dense:
            want += p[pre + "w_gate_up"].numel() + p[pre + "w_down"].numel()
        else:
            want += p[pre + "w_gate_up_shared"].numel() + p[pre + "w_down_shared"].numel()
            per_expert = (p[pre + "w_gate_up_moe"].numel() + p[pre + "w_down_moe"].numel()) // 8
            want += 2 * per_expert
    assert s.matmul_params() == want
    assert s.kv_bytes_per_token() == 6 * 2 * 2 * 16 * 4
    assert s.block_bytes() == 8 * s.kv_bytes_per_token()


def test_attention_counts_clip_the_sliding_layers_to_the_window():
    s = _shapes()  # window 16 on 5 layers, 1 full layer; 8 heads x 16
    per_key = 4.0 * 8 * 16
    assert s.attention_flops(10) == per_key * 6 * 10
    assert s.attention_flops(100) == per_key * (100 + 5 * 16)
    kv_layer = 2 * 2 * 16 * 4
    q_out = 6 * 2 * 8 * 16 * 4
    assert s.decode_attention_work(99) == (kv_layer * (100 + 5 * 16) + q_out, per_key * 180)
    # A suffix of rows 30 .. 39: the full layer reads keys 0 .. 39, a sliding
    # one keys 15 .. 39 (row 30's window starts at 15).
    nbytes, flops = s.resume_attention_work(30, 10)
    assert nbytes == kv_layer * (40 + 5 * 25) + q_out * 10
    keys = sum(p + 1 for p in range(30, 40)) + 5 * 16 * 10
    assert flops == per_key * keys


@pytest.mark.parametrize("start,n", [(0, 40), (3, 9), (10, 20), (30, 10)])
def test_prefill_flops_add_up_token_by_token(start, n):
    s = _shapes()
    want = sum(s.token_flops(p + 1, logits=False) for p in range(start, start + n))
    assert s.prefill_flops(start, n, 0) == pytest.approx(want)
    assert s.prefill_flops(start, n, 2) == pytest.approx(want + 2 * s.head_flops())


def test_moe_expert_work_counts_each_weight_set_once_and_each_pair_rows():
    s = _shapes()  # hidden 64, expert width 32
    nbytes, flops = s.moe_expert_work(5, 12)
    assert nbytes == 5 * 3 * 64 * 32 * 4 + 12 * (2 * 64 + 3 * 32) * 4
    assert flops == 6.0 * 64 * 32 * 12


# -- the readers --------------------------------------------------------------


def _recorded(device_ops, stamps=True):
    s = _shapes()
    counts = [(10.5, 40.0, 160.0, 9, 0.0), (11.5, 20.0, 80.0, 4, 7.0), (12.5, 1.0, 1.0, 1, 0.0)]
    stats = SimpleNamespace(loaded_blocks=0, computed_blocks=1, prefix_ready_us=1e5)
    if stamps:
        stats.device_counts = counts
    turn = records.Turn(prompt=[0] * 8, gen=1, t_send=10.0, t_return=12.0,
                        steps=[records.Step(7, 10.2)], stats=stats, generated=[1])
    run = records.Run(shapes=s, start=10.0, end=13.0, turns=[turn], saves=[], loads=[])
    run.trace = trace.Summary(window_s=2.0, busy_s=0.5, kernel_s={}, device_ops=device_ops,
                              idle_gaps=[], events=3)
    run.trace_span = (10.0, 12.0)
    return run


def test_moe_readers_on_a_recorded_run():
    # The library's grouped GEMM (its name as the profiler may leave it,
    # mangled) and the kernel that lays out its groups.
    ops = [["_ZN7cutlass13device_kernelIN2at4cuda6detail25enable_3x_kernel_for_sm9xINS_4gemm6kern",
            0.1], ["paged_decode_ragged", 0.2],
           ["at::cuda::detail::prepare_grouped_gemm_data", 0.01]]
    run = _recorded(ops)
    s = run.shapes
    # The stamps at 10.5 and 11.5 fall in the span (10, 12]; 12.5 does not.
    least = (roofline.least_s(*s.moe_expert_work(40.0, 160.0))
             + roofline.least_s(*s.moe_expert_work(20.0, 80.0)))
    assert _metric("kernel.moe_expert_roofline").read(run) == pytest.approx(100.0 * least / 0.11)
    assert _metric("model.moe_device_share").read(run) == pytest.approx(100.0 * 0.11 / 0.5)


@pytest.mark.parametrize("case", ["no_kernel", "no_counters", "no_trace"])
def test_moe_readers_read_nothing_where_there_is_nothing_to_read(case):
    ops = ([["paged_decode_ragged", 0.2]] if case == "no_kernel"
           else [["cutlass::device_kernel", 0.1]])
    run = _recorded(ops, stamps=case != "no_counters")
    if case == "no_trace":
        run.trace = None
    assert _metric("kernel.moe_expert_roofline").read(run) is None
    share = _metric("model.moe_device_share").read(run)
    assert share is None if case != "no_counters" else share == pytest.approx(20.0)


# -- the reference and a tiny cell --------------------------------------------


def test_afmoe_reference_imports_nothing_of_the_port():
    out = subprocess.run(
        [sys.executable, "-c",
         "import json, sys, torch\n"
         "from h100bench import arch\n"
         f"cfg = json.load(open({os.path.join(tiny.DATA, 'tiny_afmoe_config.json')!r}))\n"
         "ref = arch.find('afmoe').reference(cfg, 5, 'cpu', torch.float32)\n"
         "assert ref.logits([[1, 2, 3]], [[2]])[0].shape == (1, cfg['vocab_size'])\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, check=True, timeout=600,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    mods = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not mods & {"infinistore_tpu_torch", "infinistore_tpu", "jax", "jaxlib", "flax"}


def test_a_checkout_without_the_afmoe_block_fails_at_once(tmp_path, monkeypatch):
    """The parent of this architecture: arch/afmoe.py refuses at import,
    before a cell builds anything."""
    pkg = tmp_path / "infinistore_tpu_torch"
    (pkg / "models").mkdir(parents=True)
    (pkg / "__init__.py").write_text("")
    (pkg / "models" / "llama.py").write_text("class LlamaConfig:\n    dim: int = 1\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    monkeypatch.delitem(sys.modules, "infinistore_tpu_torch", raising=False)
    monkeypatch.delitem(sys.modules, "h100bench.arch.afmoe", raising=False)
    with pytest.raises(RuntimeError, match="cannot run an AFMoE configuration"):
        arch.find("afmoe")


def test_a_tiny_afmoe_cell_runs_correct_through_the_harness():
    bench = spec.load(tiny.BENCH)
    name = "tiny.agent_sessions"
    cell = spec.Cell(name=name, chips=1, config=_tiny(),
                     traffic_params=tiny._json("tiny_traffic.json"),
                     limits={"max_logit_gap": tiny.LIMIT},
                     end_to_end=spec._metrics(bench["end_to_end"], name),
                     per_layer=spec._metrics(bench["per_layer"], name))
    out = serve.run(cell, SEED, 2.0, False, "cpu")
    line, _ = run_mod.result(cell, out, False, {"platform": "cpu"})
    assert line["correct"], line["check"]
    done = [t for t in out["run"].turns if t.ok]
    assert done and all(t.stats.device_counts for t in done)
    for t in done:
        reads, pairs, most, skipped = (t.stats.moe_expert_reads, t.stats.moe_token_pairs,
                                       t.stats.moe_max_expert_rows, t.stats.window_keys_skipped)
        assert 0 < reads <= pairs and most >= 1 and skipped > 0


# -- near-ties ----------------------------------------------------------------


def test_the_reference_takes_the_programs_experts_at_near_ties_alone():
    mod = arch.find("afmoe")
    ref = mod.reference(_tiny(), SEED, "cpu", torch.float32)
    ref.near_tie = 0.02
    key = torch.tensor([[0.90, 0.70, 0.69, 0.10, 0.0, 0.0, 0.0, 0.0],
                        [0.90, 0.70, 0.60, 0.10, 0.0, 0.0, 0.0, 0.0],
                        [0.90, 0.70, 0.69, 0.10, 0.0, 0.0, 0.0, 0.0]])
    program = torch.tensor([[0, 2], [0, 2], [-1, -1]], dtype=torch.int16)
    got = ref._choose(key, program)
    # Row 0: 0.69 is within 0.02 of 0.70, taken; row 1: 0.60 is not; row 2:
    # no record.
    assert sorted(got[0].tolist()) == [0, 2]
    assert sorted(got[1].tolist()) == [0, 1] and sorted(got[2].tolist()) == [0, 1]
    assert (ref.adopted, ref.routed) == (1, 3)


def _tiny_bf16_cell():
    bench = spec.load(tiny.BENCH)
    name = "tiny.agent_sessions"
    return spec.Cell(name=name, chips=1, config=dict(_tiny(), torch_dtype="bfloat16"),
                     traffic_params=tiny._json("tiny_traffic.json"),
                     limits={"max_logit_gap": 0.25},
                     end_to_end=spec._metrics(bench["end_to_end"], name),
                     per_layer=spec._metrics(bench["per_layer"], name))


def test_near_tie_adoption_keeps_a_bf16_run_on_the_reference(monkeypatch, capfd):
    """bf16 swaps experts at near-ties and, with random weights, each swap
    moves every later layer: without adoption the tiny cell's bf16 run reads
    a gap over the limit; with the program's recorded choices taken at the
    near-ties it is correct."""
    mod = arch.find("afmoe")
    cell = _tiny_bf16_cell()
    out = serve.run(cell, SEED, 3.0, False, "cpu")
    assert out["max_logit_gap"] <= 0.25
    assert "afmoe reference: took the program's experts at" in capfd.readouterr().err
    monkeypatch.setattr(mod, "NEAR_TIE", 0.0)
    out = serve.run(cell, SEED, 3.0, False, "cpu")
    assert out["max_logit_gap"] > 0.25


def _route_fault(kind):
    """The program's ``route`` with a planted fault: the bias left out of the
    choice, the top k taken one rank down, or route_scale left out."""
    from infinistore_tpu_torch.models import llama

    sound = llama.route

    def route(h2, router, expert_bias, config):
        if kind == "bias_left_out":
            return sound(h2, router, torch.zeros_like(expert_bias), config)
        if kind == "route_scale_left_out":
            choice, weights = sound(h2, router, expert_bias, config)
            return choice, weights / config.route_scale
        scores = torch.sigmoid(h2.float() @ router.float())
        choice = torch.topk(scores + expert_bias.float(), config.moe_top_k + 1,
                            dim=-1).indices[:, 1:]
        weights = scores.gather(-1, choice)
        weights = weights / (weights.sum(dim=-1, keepdim=True) + 1e-20)
        return choice, weights * config.route_scale

    return route


@pytest.mark.parametrize("kind", ["bias_left_out", "top_k_one_rank_down",
                                  "route_scale_left_out"])
def test_a_routing_fault_in_the_program_is_not_correct_despite_near_tie_adoption(
        monkeypatch, kind):
    """The reference takes the program's recorded experts at near-ties
    alone: a program that routes wrongly records choices beyond them (or
    weights them wrongly), and the tiny bf16 cell reads a gap over its
    limit."""
    from infinistore_tpu_torch.models import llama

    monkeypatch.setattr(llama, "route", _route_fault(kind))
    out = serve.run(_tiny_bf16_cell(), SEED, 3.0, False, "cpu")
    assert out["max_logit_gap"] > 0.25
