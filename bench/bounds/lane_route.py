"""Least time of one feed's lane routing on the card: each key read once
(4 bytes) and its lane, rank and flags written once (9 bytes), the lane
tables (keys, last chunk, fill: 21 bytes a lane) read and written once;
16 operations a key (hash, probe, rank).  The larger of bytes at the HBM
peak and operations at the float32 peak, as the port's ``chip_smoke.py``
(``route_bound``) counts them."""
from bench import peaks


def seconds(traffic, cfg, k: int) -> float:
    T, L = traffic.chunk, cfg["lanes"]
    nbytes = T * (4 + 4 + 4 + 1) + L * (2 * 4 + 3 * 4 + 1)
    return max(nbytes / peaks.HBM_BYTES_PER_S, 16 * T / peaks.F32_FLOP_PER_S)
