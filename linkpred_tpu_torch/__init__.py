"""linkpred_tpu_torch — the PyTorch and CUDA port of `linkpred_tpu`.

The JAX package `linkpred_tpu` stays the reference; this package mirrors its
module names (`ops.segment`, `models.twowl`, `pipelines.twowl_pipeline`, ...)
so each counterpart is easy to find. It imports `torch`, never `jax`, and
nothing of the reference: the host modules it needs (`data.{graph,io,split,
twowl,synth}`, `native`) are its own copies.

Every TPU kernel on a ported path is a kernel written by hand for Hopper
(`csrc/`, built at first use by `kernels.build`). Its wrapper in
`ops.hopper_kernels` takes the plain PyTorch version only for tensors that
lie on the CPU; for a CUDA tensor it launches the kernel or raises.
"""

__version__ = "0.1.0"
