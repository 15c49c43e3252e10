from repro_torch.kernels.bitmap_join.ops import (  # noqa: F401
    bitmap_join, bitmap_join_many, bitmap_join_many_rows)
