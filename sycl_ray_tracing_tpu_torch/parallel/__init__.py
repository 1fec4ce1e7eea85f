"""Multi-device scaling: a ("data", "sample") mesh of torch.distributed
ranks, sharded rendering, distributed gradient steps."""
