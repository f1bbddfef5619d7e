"""ceph_tpu_torch — the PyTorch/CUDA port of ceph_tpu, for an NVIDIA H100.

It imports torch and numpy, never jax and nothing of `ceph_tpu`; the JAX
package stays beside it as the reference.  Layout and names mirror
`ceph_tpu` (gf/, codec/, codec/plugins/, ops/), and the one hand-written
CUDA kernel lives in csrc/.  Entry points run on `cuda` unless the caller
passes `device="cpu"`.
"""
