"""Small helpers of the proof layer (upstream bulletproofs/src/util.rs)."""


def next_power_of_two(n: int) -> int:
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()
