"""Data parallelism of the port over `torch.distributed` (counterpart of
`flow2gan_tpu/parallel/`)."""
