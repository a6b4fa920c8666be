"""Scale-out: the counterpart of ``hvi_cidnet_tpu/parallel`` (data-parallel
serving over replicas, one image's rows over a row group, multi-process
training on ``torch.distributed``)."""
