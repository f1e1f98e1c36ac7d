"""Host-side data modules of the port: `graph`, `io`, `split`, `twowl` and
`synth` (numpy only) are the port's own copies of
`linkpred_tpu/data/{graph,io,split,twowl}.py` and of the synthetic graph
generators of `benchmarks/scaling.py`, with the same names and behaviour, so
the port imports nothing of the JAX package. `subgraph` re-implements
`linkpred_tpu/data/subgraph.py`: numpy extraction, DRNL in torch."""
