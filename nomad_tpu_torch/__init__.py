"""nomad_tpu_torch: the PyTorch + CUDA port of nomad_tpu for one NVIDIA
H100. Slice 1 runs the C2M bulk-placement path ("tpu-binpack") from the
scheduler harness to a committed plan, with its device programs as
hand-written CUDA kernels (``csrc/``). It imports torch and numpy, never
jax, and nothing of the reference package."""
