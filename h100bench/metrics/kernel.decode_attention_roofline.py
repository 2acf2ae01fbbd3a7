"""kernel.decode_attention_roofline: in percent, the least time the paged
attention's work needs over the device time of K3 (paged_decode) and K6
(paged_decode_ragged) in the traced span. Work, counted by the
configuration's architecture (run.shapes), for each piece counted alone:
every decode row whose result reached the host in the span reads its
context's K and V once in every layer; every resumed suffix whose prompt
became resident in the span reads the loaded prefix once and does its
causal QK and PV. Each piece takes the larger of bytes over 3.35 TB/s and
FLOPs over 989 TFLOP/s."""

from h100bench import roofline


def read(run):
    if run.trace is None or not run.trace.kernel_s.get("decode_attention"):
        return None
    a, b = run.trace_span
    s = run.shapes
    least = 0.0
    for t in run.turns:
        if not t.ok:
            continue
        for step in t.steps:
            if a < step.t <= b:
                least += roofline.least_s(*s.decode_attention_work(step.position))
        start = run.loaded_tokens(t)
        if start and start < len(t.prompt) and a < run.prefix_ready(t) <= b:
            least += roofline.least_s(*s.resume_attention_work(start, len(t.prompt) - start))
    return 100.0 * least / run.trace.kernel_s["decode_attention"] if least else None
