"""mava_tpu_torch: the PyTorch + CUDA port of `mava_tpu`, for one NVIDIA H100.

The JAX package `mava_tpu` is the reference this port is held against; every
module here mirrors the module of the same path there. The port imports
`torch` and never JAX, and reads no file of `mava_tpu`: its YAML config tree
is its own copy, `mava_tpu_torch/configs/`, and it ships its kernel source.

Ported so far: the seven systems (ff/rec IPPO and MAPPO, rec-IQL, ff-ISAC,
ff-MASAC), nine of the environments with the wrapper chain, the MLP and CNN
torsos, and the GRU sequence recurrence (`ops/gru.py`) as hand-written CUDA
kernels for Hopper (`csrc/gru_sequence.cu`). `ROADMAP.md` lists the rest.
"""
