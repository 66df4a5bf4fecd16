"""The readings that a cell's correctness limits are set between, on the chip.

    python3 benchmark/control.py --workload <cell> --seeds <n> [<n> ...] [--calls K]
    python3 benchmark/control.py --workload <fit cell> --seeds <n> ... [--seconds S]
    python3 benchmark/control.py --workload <fit cell> --seeds <n> ... --sound [--seconds S]
    python3 benchmark/control.py --workload <fit cell> --seeds <n> ... --fault <name> [--seconds S]

The control is the plain reference computed in bfloat16, one precision
below the float32 its configurations state, put in the program's place.
For a raytrace cell, each seed's first ``K`` window calls (the configs a
run of that seed times) are worked out by the cell's reference in float32
and in bfloat16; for a fit cell, the first steps that a run of that seed
checks and, with ``--seconds``, the last step of a window that long at
the parameters the program traced it at. The bfloat16 side is judged by
the cell's check as the program's would be, and each line prints the
numbers it reads, which have to fail the cell's limits. ``--sound`` reads
a fit cell's set-up, window and check as a run makes them (the lower
readings), ``--fault`` the same with a fault of :data:`FIT_FAULTS`
planted in the program (upper readings). The benchmark's own runs do not
run this.
"""

import argparse
import json
import os
import sys
import time

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [BENCH_DIR, os.path.dirname(BENCH_DIR)]


def as_program(ref: dict) -> dict:
    """A reference result in the layout of ``raytrace``'s results dict."""
    return {"total": {"meta": {k: {"num_out": v} for k, v in ref["counts"].items()},
                      "image": ref["images"]}}


def fit_steps(cell, seed, devices, seconds):
    """A fit cell's set-up and, for ``seconds`` > 0, its window, as a run
    makes them, with the program's state freed."""
    from harness import fit

    steps = fit.Steps(cell, seed, devices)
    steps.warm()
    if seconds > 0:
        steps.window(seconds)
    steps.free()
    return steps


def readings(cell, seeds, n_calls, devices, dtype, seconds: float = 0.0) -> list:
    """The check's numbers of the cell's reference in ``dtype`` against it
    in float32, for each seed: the first ``n_calls`` window calls of a
    raytrace cell, the checked steps of a fit cell."""
    from harness import check, fit, traffic

    reference = cell.reference
    out = []
    for seed in seeds:
        if cell.traffic.get("entry") == "fit":
            last_at = fit_steps(cell, seed, devices, seconds).last_at if seconds > 0 else None
            config = fit.grad_config(cell, seed)
            slots = [k for _, s in fit.leaves(config, cell.traffic) for k in s]
            args = (config, slots, fit.offset(config, cell.traffic, len(reference.pack(config))),
                    float(cell.traffic["learning_rate"]),
                    *fit.seeds(seed, int(cell.traffic["check_steps"])))
            low = reference.follow(*args, device=devices[0], dtype=dtype, last=last_at)
            ref = reference.follow(*args, device=devices[0], last=last_at)
            numbers = check.fit_numbers(low, ref, fit.leaves(config, cell.traffic))
        else:
            shards = [devices[k % len(devices)] for k in range(traffic.shards(cell))]
            configs = [traffic.call_config(cell, seed, traffic.WINDOW, i) for i in range(n_calls)]
            low = [as_program(reference.trace(c, shards, dtype=dtype)) for c in configs]
            ref = [reference.trace(c, shards) for c in configs]
            numbers = check.numbers(low, ref)
        out.append({"seed": seed, **numbers})
    return out


# Faults of a fit's timed path, planted in the program: ``plant(patch)``
# with ``patch(module, name, value)`` (``setattr``, or pytest's monkeypatch).

def _fused_grad():
    from xicsrt_tpu_torch.ops import fused_grad

    return fused_grad


def _launcher(fn):
    """``fn`` in a K5 launcher's place: the launchers count their launches
    on the function their module's name holds."""
    fn.launches = 0
    return fn


def stale_state(patch):
    """The vjp returns zeros, so Adam leaves the state unchanged."""
    fg = _fused_grad()
    real = fg.fused_grad_vjp_cuda
    patch(fg, "fused_grad_vjp_cuda", _launcher(lambda *a, **k: real(*a, **k) * 0.0))


def half_batch(patch):
    """The forward and the vjp trace half the rays, their results doubled."""
    fg = _fused_grad()
    fwd, vjp = fg.fused_grad_forward_cuda, fg.fused_grad_vjp_cuda

    def forward(static, pvec, n_total, *a, **k):
        return 2.0 * fwd(static, pvec, n_total // 2, *a, **k)

    def adjoint(static, pvec, n_total, *a, **k):
        return 2.0 * vjp(static, pvec, n_total // 2, *a, **k)

    patch(fg, "fused_grad_forward_cuda", _launcher(forward))
    patch(fg, "fused_grad_vjp_cuda", _launcher(adjoint))


def altered_image(patch):
    """The forward's fullest pixel doubled where the K5f launcher returns it."""
    fg = _fused_grad()
    fwd = fg.fused_grad_forward_cuda

    def forward(*a, **k):
        image = fwd(*a, **k).clone()
        image[int(image.argmax())] *= 2.0
        return image

    patch(fg, "fused_grad_forward_cuda", _launcher(forward))


FIT_FAULTS = {f.__name__: f for f in (stale_state, half_batch, altered_image)}


def main(argv=None) -> int:
    import torch

    from harness import spec

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--calls", type=int, default=1)
    parser.add_argument("--seconds", type=float, default=0.0)
    parser.add_argument("--sound", action="store_true")
    parser.add_argument("--fault", choices=sorted(FIT_FAULTS))
    args = parser.parse_args(argv)
    cell = spec.resolve(spec.load_spec(), args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s)", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    devices = [f"cuda:{k}" for k in range(cell.chips)]
    t = time.perf_counter()
    if args.sound or args.fault:
        if args.fault:
            FIT_FAULTS[args.fault](setattr)  # once: it stays for the process
        for seed in args.seeds:
            numbers = fit_steps(cell, seed, devices, args.seconds).check(devices)
            print(json.dumps({"workload": args.workload, "reading": args.fault or "sound",
                              "seed": seed, **numbers}), flush=True)
    else:
        for line in readings(cell, args.seeds, args.calls, devices, torch.bfloat16,
                             args.seconds):
            print(json.dumps({"workload": args.workload, "control": "bfloat16", **line}),
                  flush=True)
    print(f"{len(args.seeds)} seeds in {time.perf_counter() - t:.1f} s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
