"""Golden model: NumPy/Python implementations replicating the reference
semantics operation-for-operation.

These are the correctness oracle for the device kernels (every device kernel
is tested against this package) and double as executable documentation of
the algorithm. They are NOT the production path — see rawalign_tpu.map /
rawalign_tpu.signal / rawalign_tpu.seeds for the batched device versions.
"""
