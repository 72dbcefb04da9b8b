"""armada_tpu_torch: the scheduling round of armada_tpu in PyTorch, for
an NVIDIA H100.

The JAX package `armada_tpu` is the reference; this package solves the
same padded round and decides the same placements, with its hot fill-loop
steps as hand-written CUDA kernels (csrc/). It imports nothing of JAX and
nothing of `armada_tpu`: the numpy host modules it needs are its own
copies.

Package layout:
  core/      resource vocabulary, quantities, priority classes, config
  snapshot/  columnar job/node/queue encodings of one round
  solver/    host prep, the torch round kernel, the round firewall
  ops/       select/bitset primitives and the CUDA kernel wrappers
  csrc/      CUDA C++ sources of the kernels
  device.py  device resolution and dtype conventions
"""

__version__ = "0.1.0"
