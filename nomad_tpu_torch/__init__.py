"""nomad_tpu_torch: the PyTorch + CUDA port of nomad_tpu for one NVIDIA
H100. Under "tpu-binpack" it runs the C2M bulk-placement path and the
per-eval general path (spread, distinct_hosts, distinct_property, small
groups) from the scheduler harness to a committed plan, with their
device programs as hand-written CUDA kernels (``csrc/``). It imports
torch and numpy, never jax, and nothing of the reference package."""
