"""Measurement scripts of the port, run on one CUDA card (each has a
``main``; ``python -m hierarchical_block_sparse_lib_tpu_torch.scripts.<name>``)."""
