"""Command-line tools of the port: ``python -m mxnet_tpu_torch.tools.launch``
starts a data-parallel job."""
