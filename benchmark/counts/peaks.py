"""The published peaks of one NVIDIA H100 SXM at its full 700 W (NVIDIA's
data sheet, dense rates): HBM bytes/s and float32 operations/s outside the
tensor cores. A share of these is stated beside the card's power limit."""

HBM_BYTES_S = 3.35e12
F32_OPS_S = 67e12


def bound_s(n_bytes, n_ops):
    """(seconds, 'bytes' or 'operations'): the least time the card could take
    to move ``n_bytes`` through HBM and do ``n_ops`` float32 operations."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_S, n_ops / F32_OPS_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
