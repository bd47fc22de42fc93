"""rawalign-tpu: raw nanopore signal mapping on NVIDIA GPUs (Seed-Filter-Align).

A from-scratch JAX framework (XLA, Pallas through Triton, and a CUDA
kernel through the XLA FFI) with the capabilities of
CMU-SAFARI/RawAlign: it maps raw ONT current signals to a reference genome
without basecalling, by converting the reference into expected signal space
with a k-mer pore model, detecting events in the raw signal, quantizing and
hashing events into seeds, chaining seed hits, and evaluating candidate
chains with banded Dynamic Time Warping.
"""

__version__ = "0.1.0"

from rawalign_tpu.config import (  # noqa: F401
    IndexOptions,
    MappingOptions,
    set_opt,
)
