"""model.mfu: in percent, the model FLOPs of the window's work over the
window's seconds times the H100's bf16 peak (989 TFLOP/s). Work, counted by
the configuration's architecture (run.shapes): each prompt token computed
(not loaded), counted when the prompt was resident, with one row of the
output head; each decode row after a turn's first (the first re-reads the
prompt's last token, whose logits the prefill already gave), counted when
its result reached the host, with the output head where a token was
chosen."""

from h100bench import roofline


def read(run):
    s = run.shapes
    flops = 0.0
    for t in run.turns:
        if not t.ok:
            continue
        if run.inside(run.prefix_ready(t)):
            start = run.loaded_tokens(t)
            flops += s.prefill_flops(start, len(t.prompt) - start, 1)
        for j, step in enumerate(t.steps[1:], start=1):
            if run.inside(step.t):
                flops += s.token_flops(step.position + 1, logits=j < t.gen)
    return 100.0 * flops / (run.seconds * roofline.PEAK_BF16_FLOPS) if flops else None
