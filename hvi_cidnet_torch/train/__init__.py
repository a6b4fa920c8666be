"""Training: the counterpart of ``hvi_cidnet_tpu/train``."""
