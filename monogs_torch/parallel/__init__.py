"""Window-sharded mapping over processes on torch.distributed (port of
monogs_tpu/parallel/)."""
