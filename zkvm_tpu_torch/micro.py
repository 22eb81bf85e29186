"""The port's field and point micro-benchmark: K13-K16 (kernels/micro.py,
csrc/field_micro.cu), the counterpart of the JAX package's
bench/pallas_micro.py.

    python -m zkvm_tpu_torch.micro [variant ...] [--device cuda]

Variants, by the reference's names (none given runs them all):
  rawmul        K14 raw: one wrapping int32 multiply a limb (Gop/s);
  mul           one multiplication an element (Mmul/s): K13 in its
                one-thread and five-lane forms (the reference's pad and
                roll layouts);
  chain         K13 in both forms at depth 8 (Mmul/s);
  planes_parts  K14's raw, prod, carry and chain at depth 1;
  addchain      K16, four lanes a point, depth 1 and 8 (Madd/s);
  addplanes     K15, one thread a point, depth 1 and 8 (Madd/s).
At B = 2^16 a launch costs about as much as the work, so each variant
also runs where the card is saturated: at B = 2^20 and depth 64 (inputs
tiled on the card), for products/s (prod), fe_mul/s (chain), int32
multiplies/s (raw), carry passes/s (carry) and Madd/s (the chains); and
on one warp alone (32 threads, 6 five-lane groups or 8 four-lane points;
the block's other warps return at once) at chains of 1,024 and 2,048,
whose difference over 1,024 is one dependent step of fe_mul, lf_mul,
pt_add or lane_add.

Inputs are the reference's rand_limbs (20 random 13-bit limbs an
element, numpy, seed 1), carried across by convert.from_jax_limbs13.
Each output is checked as the reference's check_mul checks: lanes 0, 1
and B - 1 against Python ints mod p (exact limbs for raw and prod), and
the carried outputs against field.debug_assert_limb_bounds; on the card
every output is also held whole against its kernel's plain twin, limb
for limb (the one-warp chains' twins run on the CPU).  Times: CUDA
events, the mean over the calls after one (launch included), and the
kernel's mean device time from torch.profiler ("device_ms", None where
the trace lacks it).  Rates come from the device time, else from the
events ("rate_from"); after each saturated run nvidia-smi's SM clock is
logged and kept in its row ("sm_mhz").  Runs on the card unless --device cpu, where the
plain twins run, timed by the host's clock.  Prints the card's name and
power limit, a line a measurement, and last one JSON line of them all.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from .constants import EDWARDS_D2, P
from .convert import from_jax_limbs13
from .kernels import field as F
from .kernels import micro as K
from .kernels.batch_verify_device import require_device

VARIANTS = ("rawmul", "mul", "chain", "planes_parts", "addchain",
            "addplanes")
# per kind: units of work an element-step, the rate's scale and unit
WORK = {"raw": (10, 1e9, "Gop/s"), "prod": (100, 1e9, "Gproducts/s"),
        "carry": (8, 1e9, "Gpasses/s"), "mul": (1, 1e6, "Mmul/s"),
        "add": (1, 1e6, "Madd/s")}
# what one warp holds of each kernel's elements
WARP = {"mul_thread_kernel": 32, "mul_lanes_kernel": 6,
        "add_chain_kernel": 32, "add_chain_lanes_kernel": 8}
_MASK = [(1 << w) - 1 for w in F.W]


def rand_limbs(rng, n):
    """The reference's inputs: (20, n) int32 random limbs of 13 bits."""
    return rng.integers(0, 1 << 13, size=(20, n), dtype=np.int32)


def _smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def card_name(dev) -> str:
    """The card's name and power limit, or "cpu"."""
    return _smi("name,power.limit") if dev.type == "cuda" else "cpu"


def _tile(x: torch.Tensor, n: int) -> torch.Tensor:
    reps = -(-n // x.shape[-1])
    return x.repeat(*([1] * (x.dim() - 1)), reps)[..., :n].contiguous()


def _event_ms(fn, reps):
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _host_ms(fn, reps):
    fn()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t) / reps * 1e3


def _device_ms(fn, kernel, reps):
    """Mean device ms of `kernel` (a substring of its name) per launch
    over reps calls, from torch.profiler's trace.  A trace of a long
    process can drop kernel events, so a trace without the kernel is taken
    again, up to three times; None if all three miss it."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages() if kernel in e.key]
        count = sum(e.count for e in rows)
        total = sum(getattr(e, "device_time_total", 0) for e in rows)
        if count and total:
            return total / count / 1e3
    return None


# ------------------------------------------------ checks on Python ints
def _value(limbs) -> int:
    return F.limbs_to_int([int(v) for v in limbs])


def _cols_py(f, g):
    h = [0] * 10
    for i in range(10):
        for j in range(10):
            c = (2 if i & j & 1 else 1) * (19 if i + j >= 10 else 1)
            h[(i + j) % 10] += f[i] * g[j] * c
    return h


def _add_py(p, q):
    """add-2008-hwcd-3 (a = -1, k = 2d) on (X, Y, Z, T) ints mod p."""
    X1, Y1, Z1, T1 = p
    X2, Y2, Z2, T2 = q
    A = (Y1 - X1) * (Y2 - X2)
    B = (Y1 + X1) * (Y2 + X2)
    C = T1 * EDWARDS_D2 * T2
    D = 2 * Z1 * Z2
    E, Fv, G, H = B - A, D - C, D + C, B + A
    return (E * Fv % P, G * H % P, Fv * G % P, E * H % P)


def check(kind, x, y, out, depth):
    """Lanes 0, 1 and B - 1 of out = kind(x, y) at `depth` against Python
    ints: mod p, or exactly for raw and prod's columns; the carried
    outputs also within field.debug_assert_limb_bounds (0.52 2^W)."""
    B = out.shape[-1]
    lanes = sorted({n for n in (0, 1, B - 1) if n < B})
    cols = [t[..., lanes].to("cpu", torch.int64) for t in (x, y, out)]
    for n, lane in enumerate(lanes):
        xl, yl, ol = (c[..., n].tolist() for c in cols)  # limbs, or points
        if kind == "raw":
            for a, b, o in zip(xl, yl, ol):
                v = a * pow(b, depth, 1 << 32) % (1 << 32)
                assert o == v - (v >> 31 << 32), f"raw lane {lane}"
        elif kind == "prod":
            f = xl
            for _ in range(depth):
                h = _cols_py(f, yl)
                assert _value(h) == _value(f) * _value(yl) % P
                f = [v & m for v, m in zip(h, _MASK)]
            assert ol == h, f"prod lane {lane}"
        elif kind in ("mul", "carry"):
            a, b = _value(xl), _value(yl)
            want = a * pow(b, depth, P) if kind == "mul" else a + b
            assert _value(ol) == want % P, f"{kind} lane {lane}"
        else:
            p, q = tuple(map(_value, xl)), tuple(map(_value, yl))
            for _ in range(depth):
                q = _add_py(p, q)
            assert tuple(map(_value, ol)) == q, f"add chain lane {lane}"
    if kind not in ("raw", "prod"):
        for fe in out.to(torch.int64).reshape(-1, F.NL, B):
            F.debug_assert_limb_bounds(fe, 0.52)


# ------------------------------------------------------------- the runs
def _case(kernel, fn_name, variant):
    """call(x, y, depth) on kernel's wrapper: K13 in the form whose device
    function is fn_name, K14 as `variant`."""
    if kernel == "K13":
        form = "thread" if fn_name == "mul_thread_kernel" else "lanes"
        return lambda x, y, d: K.micro_mul(x, y, d, form)
    if kernel == "K14":
        return lambda x, y, d: K.micro_parts(x, y, variant, d)
    if kernel == "K15":
        return K.micro_add_chain
    return K.micro_add_chain_lanes


def _twin(kernel, variant):
    """plain(x, y, depth), the twin of _case(kernel, ..., variant)."""
    if kernel == "K13":
        return K.micro_mul_plain
    if kernel == "K14":
        return lambda x, y, d: K.micro_parts_plain(x, y, variant, d)
    if kernel == "K15":
        return K.micro_add_chain_plain
    return K.micro_add_chain_lanes_plain


def hold(out, want, what):
    """A kernel's output against its twin's, limb for limb."""
    if not (out.dtype == want.dtype
            and torch.equal(out.to(want.device), want)):
        raise RuntimeError(f"{what} differs from its plain twin")


# variant -> [(name, kernel, device function, K14 variant, kind, depths at
# B, whether it also runs saturated)]
PLAN = {
    "rawmul": [("raw i32 mul", "K14", "raw_kernel", "raw", "raw", (1,),
                True)],
    "mul": [("mul thread", "K13", "mul_thread_kernel", None, "mul", (1,),
             False),
            ("mul lanes", "K13", "mul_lanes_kernel", None, "mul", (1,),
             False)],
    "chain": [("mul thread chain", "K13", "mul_thread_kernel", None, "mul",
               (8,), True),
              ("mul lanes chain", "K13", "mul_lanes_kernel", None, "mul",
               (8,), True)],
    "planes_parts": [
        ("parts raw", "K14", "raw_kernel", "raw", "raw", (1,), False),
        ("parts prod", "K14", "prod_kernel", "prod", "prod", (1,), True),
        ("parts carry8", "K14", "carry_kernel", "carry", "carry", (1,),
         True),
        ("parts mul", "K14", "mul_thread_kernel", "chain", "mul", (1,),
         False)],
    "addchain": [("point-add lanes", "K16", "add_chain_lanes_kernel", None,
                  "add", (1, 8), True)],
    "addplanes": [("point-add thread", "K15", "add_chain_kernel", None,
                   "add", (1, 8), True)],
}
# one-warp dependent steps a variant adds: (step, kernel, function, kind)
STEPS = {
    "chain": [("fe_mul", "K13", "mul_thread_kernel", "mul"),
              ("lf_mul", "K13", "mul_lanes_kernel", "mul")],
    "addchain": [("lane_add", "K16", "add_chain_lanes_kernel", "add")],
    "addplanes": [("pt_add", "K15", "add_chain_kernel", "add")],
}


def run(which=(), device="cuda", B=1 << 16, sat_b=1 << 20, sat_depth=64,
        steps=1024, reps=20, log=print):
    """Runs the variants `which` (all if empty) on `device`; returns the
    rows it logs, each a dict: variant, kernel, name, B, depth, ms,
    device_ms, rate, unit and rate_from; a step row has step, elements,
    steps and ns_per_step in their place."""
    dev = require_device(device)
    which = list(which) or list(VARIANTS)
    bad = [v for v in which if v not in VARIANTS]
    if bad:
        raise ValueError(f"unknown variants {bad}; known: {VARIANTS}")
    on_card = dev.type == "cuda"
    log(f"micro: device={dev} card={card_name(dev)} B={B} "
        f"saturated B={sat_b} depth={sat_depth} steps={steps}", flush=True)
    rng = np.random.default_rng(1)
    a, b = (from_jax_limbs13(rand_limbs(rng, B), dev) for _ in range(2))
    p1, p2 = (torch.stack([from_jax_limbs13(rand_limbs(rng, B), dev)
                           for _ in range(4)]) for _ in range(2))
    rows = []

    def inputs(kind, n):
        x, y = (p1, p2) if kind == "add" else (a, b)
        return _tile(x, n), _tile(y, n)

    def measure(variant, name, kernel, fn_name, part, kind, n, depth, r):
        x, y = inputs(kind, n)
        call = _case(kernel, fn_name, part)
        out = call(x, y, depth)
        check(kind, x, y, out, depth)
        if on_card:
            hold(out, _twin(kernel, part)(x, y, depth),
                 f"{kernel} {name} at B = {n}, depth {depth}")

        def fn():
            return call(x, y, depth)
        if on_card:
            ms, dms = _event_ms(fn, r), _device_ms(fn, fn_name, r)
        else:
            ms, dms = _host_ms(fn, r), None
        per, scale, unit = WORK[kind]
        t = dms if dms is not None else ms
        row = dict(variant=variant, kernel=kernel, name=name, B=n,
                   depth=depth, ms=ms, device_ms=dms,
                   rate=n * depth * per / (t / 1e3) / scale, unit=unit,
                   rate_from="device" if dms is not None else "events"
                   if on_card else "host")
        rows.append(row)
        log(f"{kernel:4s} {f'{name} x{depth}':26s} B={n:<8d} "
            f"{ms:9.4f} ms  device "
            f"{'not measured' if dms is None else f'{dms:.5f} ms'}  "
            f"{row['rate']:10.2f} {unit} ({row['rate_from']})", flush=True)

    for variant in which:
        for name, kernel, fn_name, part, kind, depths, _ in PLAN[variant]:
            for depth in depths:
                measure(variant, name, kernel, fn_name, part, kind, B, depth,
                        reps)
        for name, kernel, fn_name, part, kind, _, sat in PLAN[variant]:
            if not sat:
                continue
            measure(variant, name, kernel, fn_name, part, kind, sat_b,
                    sat_depth, max(2, reps // 4))
            if on_card:
                clock = _smi("clocks.sm,clocks.max.sm")
                rows[-1]["sm_mhz"] = int(clock.split()[0])
                log(f"     SM clock after it, and its maximum: {clock}",
                    flush=True)
        for step, kernel, fn_name, kind in STEPS.get(variant, []):
            n = WARP[fn_name]
            x, y = inputs(kind, n)
            call = _case(kernel, fn_name, None)
            depths = (steps, 2 * steps)
            outs = [call(x, y, depth) for depth in depths]
            for depth, out in zip(depths, outs):
                check(kind, x, y, out, depth)
            if on_card:   # the twin at 2 steps continues from its 1 step
                plain, xc, yc = _twin(kernel, None), x.cpu(), y.cpu()
                want = plain(xc, yc, steps)
                hold(outs[0], want, f"{kernel} {step} x{steps}")
                want = (plain(want, yc, steps) if kind == "mul"
                        else plain(xc, want, steps))
                hold(outs[1], want, f"{kernel} {step} x{2 * steps}")
            ms = []
            for depth in depths:
                timer = _event_ms if on_card else _host_ms
                ms.append(timer(lambda: call(x, y, depth), 3))
            ns = (ms[1] - ms[0]) / steps * 1e6
            rows.append(dict(variant=variant, kernel=kernel, step=step,
                             elements=n, steps=[steps, 2 * steps], ms=ms,
                             ns_per_step=ns))
            log(f"{kernel:4s} one warp, {n} elements: {step} chains of "
                f"{steps} and {2 * steps} steps {ms[0]:.4f} and {ms[1]:.4f}"
                f" ms: {ns:.1f} ns a dependent step", flush=True)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="The port's field and point micro-benchmark (K13-K16).")
    ap.add_argument("variants", nargs="*",
                    help=f"any of {', '.join(VARIANTS)} (default: all)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rows = run(args.variants, args.device)
    print(json.dumps({"card": card_name(torch.device(args.device)),
                      "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
