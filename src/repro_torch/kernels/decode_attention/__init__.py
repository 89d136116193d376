from repro_torch.kernels.decode_attention.ops import (  # noqa: F401
    decode_attention, mla_decode_attention)
