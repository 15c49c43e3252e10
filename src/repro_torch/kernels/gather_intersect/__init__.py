from repro_torch.kernels.gather_intersect.ops import (  # noqa: F401
    gather_intersect_many, gather_intersect_many_rows)
