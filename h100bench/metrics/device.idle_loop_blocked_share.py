"""device.idle_loop_blocked_share: in percent of the traced span, the
device's idle time while a ``loop.block`` is open (the event loop waiting
on the device) and no state before it in the order holds
(no wave launching, no model call, no gate held). The idle states never
overlap and sum to device.idle_share (h100bench/program_spans.py)."""

from h100bench import program_spans as ps_mod


def read(run):
    return ps_mod.idle_share(run, "loop_blocked")
