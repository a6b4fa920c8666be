"""Training losses: the counterpart of ``hvi_cidnet_tpu/losses``."""
