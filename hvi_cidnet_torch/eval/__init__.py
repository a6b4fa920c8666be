"""Dataset evaluation: the counterpart of ``hvi_cidnet_tpu/eval``."""
