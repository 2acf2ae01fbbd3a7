"""device.idle_wave_launch_share: in percent of the traced span, the device's
idle time while a ``model.wave`` is between its ``acquire`` (the gate
granted) and ``launched`` (its model call returned on the host): the host
assembling and launching a wave. The idle states never overlap and sum
to device.idle_share (h100bench/program_spans.py)."""

from h100bench import program_spans as ps_mod


def read(run):
    return ps_mod.idle_share(run, "wave_launch")
