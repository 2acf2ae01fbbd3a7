"""The port's copy of the rate-shaped measurement helper
(infinistore_tpu_torch/shaping.py) on the port's store library.

Mirrors tests/test_striping_shaped.py's edge cases on ``lib`` and
``shaping`` of the port: a zero or absent cap is unshaped, not a stall, and
a cap smaller than one chunk slows the striped roundtrip without wedging it;
and ``shaped_config`` gives the JAX package's ``ClientConfig`` field for
field."""

import dataclasses

import pytest

from infinistore_tpu_torch import lib
from infinistore_tpu_torch.shaping import BLOCK, shaped_config, shaped_roundtrip_mbps

CAP_MBPS = 40


def test_zero_cap_is_unshaped_not_a_stall():
    """cap 0/None must mean 'no pacing', not a zero-rate stall: the same
    socket-path roundtrip completes fast and well above the cap."""
    srv = lib.start_local_server(prealloc_bytes=64 << 20, block_bytes=BLOCK, enable_shm=False)
    try:
        for cap in (0, None):
            mbps, verified = shaped_roundtrip_mbps(
                srv.port, cap, 4, nbytes=16 * BLOCK, key_prefix=f"z{cap}", verify=True,
            )
            assert verified, "unshaped roundtrip corrupted data"
            assert mbps > CAP_MBPS, f"cap={cap!r} behaved like a real cap: {mbps:.0f} MB/s"
    finally:
        srv.stop()


def test_cap_smaller_than_one_chunk():
    """A cap so low that one descriptor quantum takes ~100 ms to move:
    pacing slows the transfer, never wedges it, and the bytes verify."""
    cap = 4  # MB/s per stream
    srv = lib.start_local_server(prealloc_bytes=64 << 20, block_bytes=BLOCK, enable_shm=False,
                                 pacing_rate_mbps=cap)
    try:
        stats: dict = {}
        mbps, verified = shaped_roundtrip_mbps(
            srv.port, cap, 4, nbytes=32 * BLOCK, key_prefix="tiny", verify=True,
            stats_out=stats,
        )
        assert verified, "tiny-cap roundtrip corrupted data"
        assert mbps < 100, f"pacing not applied: {mbps:.0f} MB/s"
        assert stats["chunks"] >= 4, stats  # the batch was still split
    finally:
        srv.stop()


@pytest.mark.parametrize("cap", [0, None, CAP_MBPS])
def test_shaped_config_matches_the_jax_package(cap):
    from infinistore_tpu.shaping import shaped_config as jax_shaped_config

    mine, theirs = shaped_config(1234, cap), jax_shaped_config(1234, cap)
    assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    assert mine.enable_shm is False and mine.pacing_rate_mbps == int(cap or 0)
