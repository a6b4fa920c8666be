"""Image files and eval datasets: the counterpart of ``hvi_cidnet_tpu/data``."""
