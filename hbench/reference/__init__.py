"""The plain reference the benchmark holds the port to.

Plain PyTorch and numpy, written from the models' published equations and
the datasets' construction, at the precision the configuration states
(float32 with TF32 off). It imports nothing of the port, `jax` or the JAX
package, and takes nothing the program made: it builds its own splits, edge-pair structures, message graphs and
normalisations from the input files, runs its own forward, backward and
optimizer, and reads the program's outputs only to judge them.

`precision` selects the arithmetic of a run (`precision.py`): "f32" is the
reference of a float32 configuration; "tf32" rounds every matmul's operands
to TF32 (10 mantissa bits): the control, one step below, that the
comparison has to fail.
"""
