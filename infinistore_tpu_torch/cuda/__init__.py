"""The port's device data plane: paged KV block ops, decode and prefill
attention, device <-> host staging and layer-wise streaming, with the
hand-written Hopper kernels under ``csrc/`` (built and bound by ``_ext``).

Each module mirrors its namesake under ``infinistore_tpu/tpu``. Import the
submodules directly; this package imports nothing.
"""
