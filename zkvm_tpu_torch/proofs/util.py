"""Small helpers of the proof layer (upstream bulletproofs/src/util.rs)."""

import time


def next_power_of_two(n: int) -> int:
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()


def add_time(timings: dict | None, key: str, since: float) -> None:
    """timings[key] += the seconds since `since` (no-op without timings)."""
    if timings is not None:
        timings[key] = timings.get(key, 0.0) + time.perf_counter() - since
