"""A/B kernel timings of several source trees on one NVIDIA GPU.

Run from the repository root: ``python3 chip_ab.py [--parent DIR]``.

It copies this checkout (without ``.git`` and what ``.gitignore`` lists)
under ``build/chip_ab/`` (git-ignored), once for each layout of the kernels'
templates:

- ``checkout``: the checkout as it is: K1's and K3's weight and bilinear
  stages only in their ``kStages`` 1 and 2 builds, the mosaic's only in
  ``kStages`` 2, the host taking the least a run needs, and K5's mosaic
  stage only in its ``kMosaic`` variants;
- ``all_in``: every K1 and K3 run takes its ``kStages`` 2 build and every
  K5 run its ``kMosaic`` variant, so the flagship runs with those stages
  compiled in;
- ``early_exit``, ``bounds_none``, ``bounds_torus``, ``blocks_256``,
  ``corners_all``, ``words_indexed``, ``separate_trig``, ``image_l2``:
  the checkout with one lead of the redesign of K5f and of the draws
  undone, or put back where it was dropped (``LEADS_UNDONE``).

``--layouts`` picks among them (default: all).

``--parent DIR`` adds another tree as it is, such as the parent commit
unpacked there with ``git archive``. All trees are built at once (one
``nvcc`` per source), then each tree's timings run in a process of their
own, in the order A B C ... C B A. Each prints ptxas's lines for K1
(``fused_trace_kernel``), K5f (``fused_grad_fwd_kernel``), K5b
(``fused_grad_bwd_kernel``) and R2 (``mma_rate_kernel``): registers,
spill stores, stack frame, and the 256-thread blocks a multiprocessor
holds at that register count (65536 registers, allocated per warp in
units of 256). Then the ms per call (CUDA events, the least and the median
of 5 means of 20 calls) of K1a on the flagship at 2^22 rays, of
K1c-file, K1c-mirror, K1c-cheb (example 06's mesh crystal on the mesh
spectrometer, ``mesh41``, example 06 as written), K1d and K1c-mosaic on
``chip_smoke.py``'s chains where the tree has them; of K5f and K5b on the
flagship, phase 22's chains, ``mosaic_sphere``, ``file_rocking``, the
generic source ``focused_gaussian_voigt`` and example 08's chain (its
80 KB image), at the chain's rays (2^22 for example 08's), and of K5f
with the same rays' draws read from memory and at 2^20 and 2^24 rays
(the fixed cost against the cost a ray); and of R2 at the roofline tool's
size. A tree's process ends with one JSON line of its times.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import re
import shutil
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
AB_DIR = os.path.join(ROOT, "build", "chip_ab")

# Files of the checkout, and what a layout puts in place of their lines.
ALL_IN = {
    os.path.join("xicsrt_tpu_torch", "csrc", "fused_run.cuh"):
        {"(cheb ? 3 : 0) + stages]": "(cheb ? 3 : 0) + 2]"},
    os.path.join("xicsrt_tpu_torch", "csrc", "trace_only.cu"):
        {"(cheb ? 3 : 0) + stages]": "(cheb ? 3 : 0) + 2]"},
    os.path.join("xicsrt_tpu_torch", "ops", "fused_grad.py"):
        {"| source << 2) + 12 * int(mosaic)": "| source << 2) + 12"},
}
# Each lead of the redesign undone alone, or put back where it was dropped:
# K5f's rays leaving the chain once dead or of zero weight; K5f without
# launch bounds in every variant, or with them on the torus variants too;
# K5f in blocks of 256
# only, whatever its image (example 08's 80 KB); K5f adding zero corners;
# the Philox word indexed at run time (local memory); separate sinf and
# cosf of one angle; example 08's image in global memory instead of shared.
_FWD = os.path.join("xicsrt_tpu_torch", "csrc", "fused_grad.cu")
_COMMON = os.path.join("xicsrt_tpu_torch", "csrc", "trace_common.cuh")
LEADS_UNDONE = {
    "early_exit": {_FWD: {
        "for (int e = 0; e < n_opt; ++e) {":
            "for (int e = 0; e < n_opt && st.alive && st.w != 0.0f; ++e) {"}},
    "bounds_none": {_FWD: {
        "!kTorus && (kSource == XRT_GRAD_POINT ||": "false && (kSource == XRT_GRAD_POINT ||"}},
    "bounds_torus": {_FWD: {
        "!kTorus && (kSource == XRT_GRAD_POINT ||": "(kSource == XRT_GRAD_POINT ||"}},
    "blocks_256": {_FWD: {
        "for (int t = 256; t <= 1024; t *= 2) {": "for (int t = 256; t <= 256; t *= 2) {"}},
    "corners_all": {_FWD: {
        "if (ix < 0 || ix >= nx || wx == 0.0f) continue;": "if (ix < 0 || ix >= nx) continue;",
        "if (iy < 0 || iy >= ny || v == 0.0f) continue;": "if (iy < 0 || iy >= ny) continue;"}},
    "words_indexed": {_COMMON: {
        "return (float)(((k & 2) ? hi : lo) >> 8) * (1.0f / 16777216.0f);":
            "return (float)(words[k & 3] >> 8) * (1.0f / 16777216.0f);"}},
    "separate_trig": {_COMMON: {
        "    sincosf(x, &s, &c);": "    s = sinf(x);\n    c = cosf(x);"}},
    "image_l2": {_FWD: {
        "kFwdSmemImageMax = XRT_SMEM_IMAGE_MAX_FLOATS;": "kFwdSmemImageMax = 16384;"}},
}
LAYOUTS = {"checkout": {}, "all_in": ALL_IN, **LEADS_UNDONE}


def make_tree(name: str, edits: dict) -> str:
    """A copy of the checkout with the lines ``edits`` ({file: {line:
    replacement}}) replaced."""
    tree = os.path.join(AB_DIR, name)
    shutil.rmtree(tree, ignore_errors=True)
    with open(os.path.join(ROOT, ".gitignore")) as f:
        ignored = [line.strip().rstrip("/") for line in f
                   if line.strip() and not line.startswith("#")]
    shutil.copytree(ROOT, tree, ignore=shutil.ignore_patterns(".git", *ignored))
    for relpath, lines in edits.items():
        path = os.path.join(tree, relpath)
        with open(path) as f:
            src = f.read()
        for line, new in lines.items():
            if src.count(line) != 1:
                raise AssertionError(f"{name}: line not found once in {relpath}: {line}")
            src = src.replace(line, new)
        with open(path, "w") as f:
            f.write(src)
    return tree


def child_command(tree: str, mode: str) -> list:
    """A process that runs this file's :func:`child` on ``tree``, importing
    that tree's package and ``chip_smoke.py``."""
    here = os.path.abspath(__file__)
    code = (f"import sys, runpy; sys.path[:0] = [{tree!r}]; "
            f"runpy.run_path({here!r})['child']({tree!r}, {mode!r})")
    return [sys.executable, "-c", code]


def blocks_per_sm(registers: int) -> int:
    """256-thread blocks a multiprocessor holds at ``registers`` a thread."""
    per_warp = -(-registers * 32 // 256) * 256
    return min(65536 // (per_warp * 8), 8)


def ptxas_lines(report: str) -> list:
    """(kernel, registers, spill stores, stack frame bytes) of K1, K5f, K5b
    and R2 from ptxas's report."""
    out, name, stores, frame = [], None, 0, 0
    for line in report.splitlines():
        m = re.search(r"(fused_trace_kernel|fused_grad_fwd_kernel(?:_64)?"
                      r"|fused_grad_bwd_kernel|mma_rate_kernel)(I\w+?E)?E", line)
        if m:
            name, stores, frame = m.group(1) + (m.group(2) or ""), 0, 0
            continue
        spill = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores", line)
        if name and spill:
            frame, stores = int(spill.group(1)), int(spill.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if name and m:
            out.append((name, int(m.group(1)), stores, frame))
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
    for name, regs, stores, frame in ptxas_lines(native.ptxas_report()):
        print(f"{label} ptxas {name}: {regs} registers, {stores} bytes spill stores, "
              f"{frame} bytes stack frame, {blocks_per_sm(regs)} blocks of 256 per "
              f"multiprocessor", flush=True)

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
            "K1c-cheb": cs.mesh_config(n, 1, "fused", cls, **kw),
            "K1c-cheb mesh41": cs.BS.SCENARIOS["mesh41"](n, 1)})
        example06 = cs.example_config("example_06_fused_engine.py")
        example06["sources"]["source"]["intensity"] = n
        chains["K1c-cheb example06"] = example06
    grad_chains = {"flagship": cs.grad_flagship(n, 1), **cs.grad_timing_configs()}
    if hasattr(cs, "mosaic15_config"):
        chains.update({
            "K1d-weight": cs.flagship(n, 1, engine="fused", interact_mode="weight"),
            "K1d-bilinear": cs.flagship(n, 1, engine="fused", image_mode="bilinear"),
            "K1c-mosaic mc": cs.mosaic15_config(n, 1, "fused"),
            "K1c-mosaic weight": cs.mosaic15_config(n, 1, "fused", interact_mode="weight")})
        grad_chains["mosaic_sphere"] = cs.grad_variant("mosaic_sphere", n)
    if hasattr(cs, "file_rocking_config"):
        grad_chains["file_rocking"] = cs.grad_variant("file_rocking", n)
        grad_chains["focused_gaussian_voigt"] = cs.grad_variant("focused_gaussian_voigt", n)
    # Example 08's chain: its detector image is 80 KB.
    grad_chains["example08"] = cs.repo_function("examples/example_08_plasma_fitting.py",
                                                "_config")(8.3e20, 2.0e4)
    for name, cfg in chains.items():
        fparams = cs.k1_pack(engine.Pipeline(cfg, device="cuda"))
        times[name] = ms(lambda: ft.fused_run_cuda(fparams, n, n, seed=(1, 2)))
    for name, cfg in grad_chains.items():
        _, _, pack, pipe = make_fused_differentiable(cfg, device="cuda")
        pvec = pack(pipe.params).detach()
        spec = fg.build_fused_diff(pipe, num_iter=1)[3]
        st, lam = spec["static"], spec["lam"]
        m = n if name == "example08" else spec["n_total"]
        g = torch.randn(st.img_total, device="cuda")
        times[f"K5f {name}"] = ms(
            lambda: fg.fused_grad_forward_cuda(st, pvec, m, lam, seed=(1, 2)))
        times[f"K5b {name}"] = ms(
            lambda: fg.fused_grad_vjp_cuda(st, pvec, m, lam, g, seed=(1, 2)))
        if name == "example08":
            continue
        # The same rays' draws read from memory (n_draws float32 a ray)
        # instead of Philox, and the fixed cost against the cost a ray.
        u = torch.rand((st.n_draws, n), device="cuda")
        times[f"K5f {name} uniforms"] = ms(
            lambda: fg.fused_grad_forward_cuda(st, pvec, n, lam, uniforms=u))
        del u
        for k in (20, 24):
            times[f"K5f {name} 2^{k}"] = ms(
                lambda: fg.fused_grad_forward_cuda(st, pvec, 1 << k, lam, seed=(1, 2)))
    if importlib.util.find_spec("xicsrt_tpu_torch.ops.roofline_probes"):
        from xicsrt_tpu_torch.ops import roofline_probes as rp

        seed = torch.tensor([0.011], dtype=torch.float32, device="cuda")
        times["R2"] = ms(lambda: rp.mma_rate_cuda(seed))
    for name, (low, mid) in times.items():
        print(f"{label} {name}: {low:.4f} ms least, {mid:.4f} ms median", flush=True)
    print(json.dumps({"tree": label, "ms": times}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="another tree to time as it is")
    ap.add_argument("--layouts", nargs="+", choices=sorted(LAYOUTS), default=list(LAYOUTS),
                    help="the layouts of the checkout to time (default: all)")
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(f"card: {smi.stdout.strip() or 'unknown'}", flush=True)
    trees = [make_tree(name, LAYOUTS[name]) for name in args.layouts]
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
