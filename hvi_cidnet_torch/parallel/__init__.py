"""Scale-out: the counterpart of ``hvi_cidnet_tpu/parallel`` (data-parallel
serving over replicas, multi-process training on ``torch.distributed``)."""
