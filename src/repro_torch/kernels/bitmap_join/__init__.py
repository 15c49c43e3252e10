from repro_torch.kernels.bitmap_join.ops import bitmap_join_many  # noqa: F401
