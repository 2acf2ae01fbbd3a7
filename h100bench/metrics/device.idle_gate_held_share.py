"""device.idle_gate_held_share: in percent of the traced span, the device's
idle time while an exclusive ``engine.gate`` of kind install, load, prefill
or resume is held, no wave is launching and no ``model.*`` call is open:
the gate's holder waiting, on the store or on the host. The idle states
never overlap and sum to device.idle_share (h100bench/program_spans.py)."""

from h100bench import program_spans as ps_mod


def read(run):
    return ps_mod.idle_share(run, "gate_held")
