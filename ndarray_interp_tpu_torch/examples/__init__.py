"""Examples of the port: run one with ``python -m ndarray_interp_tpu_torch.examples.<name>``."""
