"""`python -m linkpred_tpu_torch` — the CLI."""

from linkpred_tpu_torch.cli import main

main()
