"""Data parallelism: one process per device over ``torch.distributed``."""
