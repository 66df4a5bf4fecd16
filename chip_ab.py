"""A/B kernel timings of several source trees on one NVIDIA GPU.

Run from the repository root: ``python3 chip_ab.py [--parent DIR]``.

It copies this checkout (without ``.git`` and what ``.gitignore`` lists)
under ``build/chip_ab/`` (git-ignored), once for each layout of the fused
trace chain's template (``xicsrt_tpu_torch/csrc/trace_chain.cuh``):

- ``cheb_only``: the checkout as it is: the mirror and file-curve stages
  in every K1 and K3 build, only the Chebyshev stage behind ``kCheb``;
- ``no_ext``: every stage in every build (both values of ``kCheb`` then
  compile the same code);
- ``ext``: the mirror and file-curve stages behind the template too. The
  host still picks the template's build from the chain's mesh alone, so
  this layout traces file and mirror chains without their stages: only
  its K1a and K1c-cheb are timed.

``--parent DIR`` adds another tree as it is, such as the parent commit
unpacked there with ``git archive``. All trees are built at once (one
``nvcc`` per source), then each tree's timings run in a process of their
own, in the order A B C ... C B A. Each prints ptxas's lines for K1
(``fused_trace_kernel``) and K5f (``fused_grad_fwd_kernel``) with the
number of 256-thread blocks a multiprocessor holds at that register count
(65536 registers, allocated per warp in units of 256), and the ms per call
(CUDA events, the least and the median of 5 means of 20 calls) of K1a on
the flagship at 2^22 rays, of K1c-file, K1c-mirror and K1c-cheb on
``chip_smoke.py``'s phase 31 chains where the tree has them, and of K5f and
K5b on phase 22's chains. A tree's process ends with one JSON line of its
times.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
AB_DIR = os.path.join(ROOT, "build", "chip_ab")
CHAIN = os.path.join("xicsrt_tpu_torch", "csrc", "trace_chain.cuh")

# Lines of the checkout's chain, and what a layout puts in their place.
CHEB_GUARDS = {
    "} else if (kCheb && oi[0] == XRT_SHAPE_CHEB) {":
        "} else if (oi[0] == XRT_SHAPE_CHEB) {",
    "if (oi[0] != 0 && !(kCheb && oi[0] == XRT_SHAPE_CHEB)) {":
        "if (oi[0] != 0 && oi[0] != XRT_SHAPE_CHEB) {",
}
MORE_GUARDS = {
    "} else if (oi[3] != XRT_ROCK_FILE) {": "} else if (!kCheb || oi[3] != XRT_ROCK_FILE) {",
    "} else if (oi[2] == 2 && mask) {": "} else if (kCheb && oi[2] == 2 && mask) {",
}
LAYOUTS = {"cheb_only": {}, "no_ext": CHEB_GUARDS, "ext": MORE_GUARDS}
# The chains a layout cannot trace as the checkout's host drives it.
UNTIMED = {"ext": ("K1c-mirror", "K1c-file")}


def make_tree(name: str, edits: dict) -> str:
    """A copy of the checkout with the chain's lines ``edits`` replaced."""
    tree = os.path.join(AB_DIR, name)
    shutil.rmtree(tree, ignore_errors=True)
    with open(os.path.join(ROOT, ".gitignore")) as f:
        ignored = [line.strip().rstrip("/") for line in f
                   if line.strip() and not line.startswith("#")]
    shutil.copytree(ROOT, tree, ignore=shutil.ignore_patterns(".git", *ignored))
    path = os.path.join(tree, CHAIN)
    with open(path) as f:
        src = f.read()
    for line, new in edits.items():
        if src.count(line) != 1:
            raise AssertionError(f"{name}: line not found once: {line}")
        src = src.replace(line, new)
    with open(path, "w") as f:
        f.write(src)
    return tree


def child_command(tree: str, mode: str) -> list:
    """A process that runs :func:`child` on ``tree``, importing that tree's
    package and ``chip_smoke.py``."""
    code = (f"import sys; sys.path[:0] = [{tree!r}, {ROOT!r}]; import chip_ab; "
            f"chip_ab.child({tree!r}, {mode!r})")
    return [sys.executable, "-c", code]


def blocks_per_sm(registers: int) -> int:
    """256-thread blocks a multiprocessor holds at ``registers`` a thread."""
    per_warp = -(-registers * 32 // 256) * 256
    return min(65536 // (per_warp * 8), 8)


def ptxas_lines(report: str) -> list:
    """(kernel, registers, spill stores) of K1 and K5f from ptxas's report."""
    out, name, stores = [], None, 0
    for line in report.splitlines():
        m = re.search(r"(fused_trace_kernel|fused_grad_fwd_kernel)(I\w+?E)E", line)
        if m:
            name, stores = m.group(1) + m.group(2), 0
            continue
        spill = re.search(r"(\d+) bytes spill stores", line)
        if name and spill:
            stores = int(spill.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if name and m:
            out.append((name, int(m.group(1)), stores))
            name = None
    return out


def child(tree: str, mode: str) -> None:
    """Build ``tree``'s kernels (mode 'build'), or time them (mode 'time')."""
    from xicsrt_tpu_torch.ops import native

    if mode == "build":
        native.build()
        return
    import torch

    import chip_smoke as cs
    from xicsrt_tpu_torch import engine
    from xicsrt_tpu_torch.gradients import make_fused_differentiable
    from xicsrt_tpu_torch.ops import fused_grad as fg
    from xicsrt_tpu_torch.ops import fused_trace as ft

    label = os.path.basename(tree)
    for name, regs, stores in ptxas_lines(native.ptxas_report()):
        print(f"{label} ptxas {name}: {regs} registers, {stores} bytes spill stores, "
              f"{blocks_per_sm(regs)} blocks of 256 per multiprocessor", flush=True)

    def ms(fn) -> tuple:
        means = [cs.cuda_ms(fn, 20) for _ in range(5)]
        return min(means), statistics.median(means)

    n = 1 << 22
    times = {}
    chains = {"K1a": cs.flagship(n, 1, engine="fused")}
    if hasattr(cs, "mesh_config"):
        cls, kw = cs.MESH_CRYSTALS["mesh_sphere"]
        chains.update({
            "K1c-mirror": cs.mirror_configs(n, 1, "fused")["flagship_no_check"],
            "K1c-file": cs.file_crystal_config(n, 1, "fused"),
            "K1c-cheb": cs.mesh_config(n, 1, "fused", cls, **kw)})
    for name, cfg in chains.items():
        if name in UNTIMED.get(label, ()):
            continue
        fparams = cs.k1_pack(ft, engine.Pipeline(cfg, device="cuda"))
        times[name] = ms(lambda: ft.fused_run_cuda(fparams, n, n, seed=(1, 2)))
    for name, cfg in cs.grad_timing_configs().items():
        _, _, pack, pipe = make_fused_differentiable(cfg, device="cuda")
        pvec = pack(pipe.params).detach()
        spec = fg.build_fused_diff(pipe, num_iter=1)[3]
        st, lam, m = spec["static"], spec["lam"], spec["n_total"]
        g = torch.randn(st.img_total, device="cuda")
        times[f"K5f {name}"] = ms(
            lambda: fg.fused_grad_forward_cuda(st, pvec, m, lam, seed=(1, 2)))
        times[f"K5b {name}"] = ms(
            lambda: fg.fused_grad_vjp_cuda(st, pvec, m, lam, g, seed=(1, 2)))
    for name, (low, mid) in times.items():
        print(f"{label} {name}: {low:.4f} ms least, {mid:.4f} ms median", flush=True)
    print(json.dumps({"tree": label, "ms": times}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="another tree to time as it is")
    args = ap.parse_args()
    trees = [make_tree(name, edits) for name, edits in LAYOUTS.items()]
    if args.parent:
        trees.insert(0, os.path.abspath(args.parent))
    builds = [subprocess.Popen(child_command(t, "build"), cwd=t) for t in trees]
    if any(p.wait(timeout=900) for p in builds):
        raise RuntimeError("a tree's kernels did not build")
    for tree in trees + trees[::-1]:
        proc = subprocess.run(child_command(tree, "time"), cwd=tree, text=True,
                              capture_output=True, timeout=900)
        print(proc.stdout, end="", flush=True)
        if proc.returncode:
            print(proc.stderr, file=sys.stderr)
            raise RuntimeError(f"{tree}: the timings failed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
