"""The benchmark of openrec_tpu_torch: `python3 portbench/run.py --help`."""
