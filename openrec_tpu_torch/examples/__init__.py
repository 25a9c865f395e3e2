"""Example scripts of the port, one per JAX example it mirrors (run each
with `python -m openrec_tpu_torch.examples.<name>` from the repository's
root). Each runs on CUDA unless OPENREC_EXAMPLE_DEVICE names another
device, and honours the JAX examples' quick-run overrides
OPENREC_EXAMPLE_ITERS, OPENREC_EXAMPLE_EVAL_INTERVAL and
OPENREC_EXAMPLE_SMALL."""
